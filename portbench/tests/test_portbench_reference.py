"""The plain reference against the program on the CPU: the tables it
compiles from a configuration's data are the port's, and its bounce
(a frozen copy) traces as the port's plain version does, bit for bit."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench import scene as S
from portbench.reference import bounce as rb
from portbench.reference import tables as rt
from portbench.reference import trace as rtrace


def _rough_plates():
    """The multiple-importance-sampling demo's layout (four rough metal
    plates under four emitting spheres, radii a quarter of each other),
    with constant emission: the reference's rough-conductor and
    light-sampling branches, which no configuration file uses."""
    def box(name, lower, upper, transform, material):
        return dict(name=name, shape="box", lower=lower, upper=upper,
                    parent="world", transform=transform, material=material)
    prims = [box("floor", [-10, -0.1, -10], [10, 0, 10], [],
                 {"type": "lambert", "reflectivity": {"constant": 0.5}}),
             box("backdrop", [-10, 0, 4], [10, 10, 4.1], [],
                 {"type": "lambert", "reflectivity": {"constant": 0.2}})]
    for i in range(4):
        prims.append(dict(
            name=f"emitter {i}", shape="sphere", radius=0.5 / 4 ** i,
            parent="world", transform=[["translate",
                                        [-1.8 + 1.2 * i, 2.2, 2.0]]],
            material={"type": "uniform_emitter",
                      "emission": {"constant": 1.0}, "scale": 16.0 ** i}))
    for i, rough in enumerate((0.02, 0.05, 0.15, 0.4)):
        prims.append(box(
            f"plate {i}", [-2.4, -0.02, -0.3], [2.4, 0.0, 0.3],
            [["translate", [0, 0.35 + 0.45 * i, 0.6 + 0.6 * i]],
             ["rotate", [0, 62 - 8 * i, 0]]],
            {"type": "rough_conductor", "index": {"constant": 0.9},
             "extinction": {"constant": 6.0}, "roughness": rough}))
    return {"name": "rough_plates", "precision": "float32", "nodes": [],
            "primitives": prims,
            "spectral": {"min_wavelength": 375.0, "max_wavelength": 740.0,
                         "bins": 12},
            "ray": {"max_depth": 50, "extinction_prob": 0.01,
                    "extinction_min_depth": 3, "importance_sampling": True,
                    "important_path_weight": 0.3}}


CONFIGS = ["cornell_box", "rough_plates"]


def _config(name):
    if name == "rough_plates":
        return _rough_plates()
    return harness.load_json("configs", f"{name}.json")


def _port(name):
    import source_tpu_torch as T
    from source_tpu_torch.tracer import fused
    cfg = _config(name)
    sp = cfg["spectral"]
    scene = T.compile_scene(S.build_world(cfg), T.SpectralConfig(
        sp["min_wavelength"], sp["max_wavelength"], sp["bins"]),
        device="cpu")
    spec, entry = fused.scene_tables(scene, S.ray_config(T, cfg, 8,
                                                         "float32"))
    return cfg, scene, spec, fused.forward_table(scene, spec, entry), fused


@pytest.mark.parametrize("name", CONFIGS)
def test_tables_and_spec_are_the_ports(name):
    cfg, scene, spec, tab, _fused = _port(name)
    tables, rspec = rt.compile_config(cfg)
    for f in rt.TABLE_FIELDS:
        assert torch.equal(tables[f], getattr(scene, f)), f
    assert rspec.leaves == spec.leaves and rspec.volumes == spec.volumes
    assert rspec.mat_types == spec.mat_types and rspec.n_imp == spec.n_imp
    assert torch.equal(rb.pack_tabvec(tables, rspec), tab)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_bounce_is_the_ports_plain_version(name):
    import source_tpu_torch as T
    cfg, scene, spec, tab, fused = _port(name)
    tables, rspec = rt.compile_config(cfg)
    from portbench.traffic.common import grid_rays
    o, d = grid_rays({"width": 12, "height": 12, "spread": 0.8,
                      "position": [0.0, 1.0, -3.3]}, "cpu")
    u = torch.rand((8, 144, 10), generator=torch.Generator().manual_seed(7))
    st = T.init_rays(o, d, cfg["spectral"]["bins"])
    port, bits = fused.span_fwd_plain(spec, tab, fused.pack_state(st),
                                      fused.pack_u(u))
    ref, seg = rtrace.span(rspec, rb.pack_tabvec(tables, rspec),
                           rtrace.pack(o, d, torch.ones_like(
                               port["rad"].t()), torch.zeros_like(
                               port["rad"].t())), u, 8)
    assert torch.equal(ref["rad"], port["rad"])
    assert int(seg) == int((bits & 1).sum())
