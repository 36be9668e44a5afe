"""A configuration's scene, built through the port's scenegraph API.

A configuration file (``configs/<name>.json``) holds the scene as data:
named nodes, primitives with their transforms, and each primitive's
material with its spectra written out. ``build_world`` turns it into a port
``World`` with the public classes of ``source_tpu_torch`` (scenegraph,
primitives, materials, spectral functions). It reads no program data: no
stock scene, glass catalog or illuminant table of the port.
"""

from __future__ import annotations

import numpy as np


def _transform(T, ops):
    m = T.translate(0, 0, 0)
    for op, args in ops:
        m = m * getattr(T, op)(*args)
    return m


def _spectral_function(O, spec):
    if "constant" in spec:
        return O.ConstantSF(float(spec["constant"]))
    samples = np.asarray(spec["samples"], dtype=np.float64)
    if "divide_by" in spec:
        samples = samples / float(spec["divide_by"])
    return O.InterpolatedSF(np.asarray(spec["wavelengths"], np.float64),
                            samples)


def _material(O, M, spec):
    kind = spec["type"]
    if kind == "lambert":
        return M.Lambert(_spectral_function(O, spec["reflectivity"]))
    if kind == "uniform_emitter":
        return M.UniformSurfaceEmitter(_spectral_function(O, spec["emission"]),
                                       float(spec["scale"]))
    if kind == "rough_conductor":
        return M.RoughConductor(_spectral_function(O, spec["index"]),
                                _spectral_function(O, spec["extinction"]),
                                float(spec["roughness"]))
    if kind == "dielectric":
        b1, b2, b3, c1, c2, c3 = spec["index"]["sellmeier"]
        index = M.Sellmeier(b1, b2, b3, c1, c2, c3,
                            spec["index"]["sample_resolution"])
        tr = spec["transmission"]
        w = np.asarray(tr["tau25_wavelengths"], dtype=np.float64)
        tau = np.asarray(tr["tau25"], dtype=np.float64) ** tr["power"]
        order = np.argsort(w)
        return M.Dielectric(index, O.InterpolatedSF(w[order], tau[order]),
                            O.ConstantSF(float(spec["external_index"])))
    raise ValueError(f"unknown material type {kind!r}")


def build_world(config):
    """A port ``World`` of the configuration's nodes and primitives, in the
    file's order (which fixes the compiled tables' row order)."""
    import source_tpu_torch as T
    from source_tpu_torch import optical as O
    from source_tpu_torch.optical import material as M
    from source_tpu_torch.primitive import Box, Sphere

    world = T.World()
    nodes = {"world": world}
    for n in config["nodes"]:
        nodes[n["name"]] = T.Node(nodes[n["parent"]],
                                  transform=_transform(T, n["transform"]))
    for p in config["primitives"]:
        kw = dict(parent=nodes[p["parent"]],
                  transform=_transform(T, p["transform"]),
                  material=_material(O, M, p["material"]), name=p["name"])
        if p["shape"] == "box":
            Box(T.Point3D(*p["lower"]), T.Point3D(*p["upper"]), **kw)
        elif p["shape"] == "sphere":
            Sphere(float(p["radius"]), **kw)
        else:
            raise ValueError(f"unknown shape {p['shape']!r}")
    return world


def ray_config(T, config, max_iters, spectral_dtype):
    """The port's ``RayConfig`` of the configuration's ray settings, with no
    compaction (a ray batch's one span)."""
    r = config["ray"]
    return T.RayConfig(
        max_depth=r["max_depth"], extinction_prob=r["extinction_prob"],
        extinction_min_depth=r["extinction_min_depth"],
        importance_sampling=r["importance_sampling"],
        important_path_weight=r["important_path_weight"],
        max_iters=max_iters, spectral_dtype=spectral_dtype)
