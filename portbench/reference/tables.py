"""The plain reference's scene tables, built from a configuration's data.

A configuration (``configs/<name>.json``) is compiled here into the flat
tables that the reference bounce reads, with numpy in float64 and a cast
to float32 at the end: the leaves' world-to-local transforms and
parameter blocks, the materials' parameters, spectra and band averages,
and the importance spheres of the emitters and dielectrics. The layout is
the one the fused bounce of Raysect's algorithm needs (leaves sorted by
solid type, one material row a primitive), so that a gradient of the
program's tables can be set beside the reference's field by field. Nothing
here imports the program or reads a table it made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

TYPE_SPHERE, TYPE_BOX = 0, 1
MAT_LAMBERT, MAT_EMITTER, MAT_ROUGH_CONDUCTOR, MAT_DIELECTRIC = 1, 2, 5, 6
VOL_BEER = 1
NPARAMS, NSLOTS, NSCALARS, PARAM_BLOCK = 8, 4, 4, 8
BOX_PAD = 1e-5
SPHERE_PAD = 1.0001

# the float tables a gradient lands on, in the order the program names them
TABLE_FIELDS = ("leaf_w2l", "leaf_params", "mat_params", "mat_spectra",
                "mat_scalars", "imp_centre", "imp_radius", "imp_weight",
                "imp_cdf", "entity_w2l")


# --- transforms (Raysect's conventions, degrees) -------------------------------

def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _rot(axis, angle):
    r = math.pi / 180.0 * angle
    c, s = math.cos(r), math.sin(r)
    m = np.eye(4)
    i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def rotate(yaw, pitch, roll):
    """Intrinsic rotation, axis order (-Y)(-X)'Z''."""
    return _rot("y", -yaw) @ _rot("x", -pitch) @ _rot("z", roll)


def transform_of(ops):
    m = np.eye(4)
    for op, args in ops:
        m = m @ {"translate": translate, "rotate": rotate}[op](*args)
    return m


# --- spectral functions --------------------------------------------------------

def _integral_to(x, y, q):
    """Integral of the piecewise-linear function from x[0] to q, constant
    beyond both ends."""
    seg = 0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1])
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    qc = np.clip(q, x[0], x[-1])
    i = np.clip(np.searchsorted(x, qc, side="right") - 1, 0, x.shape[0] - 2)
    x0, x1, y0, y1 = x[i], x[i + 1], y[i], y[i + 1]
    t = (qc - x0) / np.where(x1 > x0, x1 - x0, 1.0)
    yq = y0 + (y1 - y0) * t
    inside = cum[i] + 0.5 * (y0 + yq) * (qc - x0)
    below = y[0] * (q - x[0])
    above = cum[-1] + y[-1] * (q - x[-1])
    return np.where(q < x[0], below, np.where(q > x[-1], above, inside))


def interpolated_bins(x, y, lo, hi, bins):
    """Per-bin means of a linearly interpolated curve over equal bins."""
    order = np.argsort(x)
    x, y = np.asarray(x, np.float64)[order], np.asarray(y, np.float64)[order]
    edges = lo + (hi - lo) * np.arange(bins + 1) / bins
    cum = _integral_to(x, y, edges)
    return (cum[1:] - cum[:-1]) / ((hi - lo) / bins)


def _sellmeier(coef, w):
    b1, b2, b3, c1, c2, c3 = coef
    w2 = w * w * 1e-6
    return math.sqrt(1 + b1 * w2 / (w2 - c1) + b2 * w2 / (w2 - c2)
                     + b3 * w2 / (w2 - c3))


def _trapezoid_integral(f, lo, hi, resolution):
    if hi <= lo:
        return 0.0
    n = max(2, int(np.ceil((hi - lo) / resolution)) + 1)
    w = np.linspace(lo, hi, n)
    return float(np.trapezoid(np.array([f(v) for v in w]), w))


def sellmeier_bins(coef, resolution, lo, hi, bins):
    edges = np.linspace(lo, hi, bins + 1)
    delta = (hi - lo) / bins
    return np.array([_trapezoid_integral(lambda w: _sellmeier(coef, w),
                                         edges[i], edges[i + 1], resolution)
                     / delta for i in range(bins)])


def sellmeier_average(coef, resolution, lo, hi):
    return _trapezoid_integral(lambda w: _sellmeier(coef, w), lo, hi,
                               resolution) / (hi - lo)


def curve_bins(spec, lo, hi, bins):
    if "constant" in spec:
        return np.full(bins, float(spec["constant"]))
    y = np.asarray(spec["samples"], np.float64)
    if "divide_by" in spec:
        y = y / float(spec["divide_by"])
    return interpolated_bins(spec["wavelengths"], y, lo, hi, bins)


def material_rows(spec, lo, hi, bins):
    """(type, params[8], spectra[4, B], scalars[4], importance, volume)."""
    params = np.zeros(NPARAMS)
    spectra = np.zeros((NSLOTS, bins))
    scalars = np.zeros(NSCALARS)
    kind = spec["type"]
    if kind == "lambert":
        spectra[0] = curve_bins(spec["reflectivity"], lo, hi, bins)
        return MAT_LAMBERT, params, spectra, scalars, 0.0, 0
    if kind == "uniform_emitter":
        spectra[0] = curve_bins(spec["emission"], lo, hi, bins) * float(
            spec["scale"])
        return MAT_EMITTER, params, spectra, scalars, 1.0, 0
    if kind == "rough_conductor":
        spectra[0] = curve_bins(spec["index"], lo, hi, bins)
        spectra[1] = curve_bins(spec["extinction"], lo, hi, bins)
        params[0] = float(spec["roughness"])
        return MAT_ROUGH_CONDUCTOR, params, spectra, scalars, 0.0, 0
    if kind == "dielectric":
        coef, res = spec["index"]["sellmeier"], spec["index"][
            "sample_resolution"]
        tr = spec["transmission"]
        tau = np.asarray(tr["tau25"], np.float64) ** tr["power"]
        spectra[0] = sellmeier_bins(coef, res, lo, hi, bins)
        spectra[1] = interpolated_bins(tr["tau25_wavelengths"], tau, lo, hi,
                                       bins)
        scalars[0] = sellmeier_average(coef, res, lo, hi)
        scalars[1] = float(spec["external_index"])
        return MAT_DIELECTRIC, params, spectra, scalars, 1.0, VOL_BEER
    raise ValueError(f"unknown material type {kind!r}")


# --- the tables ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """What the bounce unrolls over: (type, entity, material, record kind)
    a leaf (kind 0 local frame, 1 world sphere, 2 world box), the material
    types, the Beer-Lambert volumes (entity, material, kind, leaf), the
    importance spheres, and the ray settings."""

    leaves: Tuple
    mat_types: Tuple
    volumes: Tuple
    n_imp: int
    has_importance: bool
    bins: int
    max_depth: int
    extinction_prob: float
    extinction_min_depth: int
    importance_sampling: bool
    important_path_weight: float
    max_distance: float = float("inf")
    check_entities: Tuple = ()


def general(spec):
    """Every leaf as a local-frame record (the differentiable route's)."""
    return dataclasses.replace(
        spec, leaves=tuple((t, e, m, 0) for (t, e, m, _k) in spec.leaves))


def _box_sphere(lower, upper, l2w):
    pts = np.array([(l2w @ np.array([x, y, z, 1.0]))[:3]
                    for x in (lower[0], upper[0]) for y in (lower[1], upper[1])
                    for z in (lower[2], upper[2])])
    pad = BOX_PAD * max(1.0, float(np.abs(pts).max()))
    lo, hi = pts.min(axis=0) - pad, pts.max(axis=0) + pad
    centre = 0.5 * (lo + hi)
    return centre, float(np.linalg.norm(hi - centre))


def slice_bounds(sp):
    """The wavelength range of an observer's one spectral slice, as the
    observer works it out: the top edge is min + delta * bins."""
    lo, hi, B = float(sp["min_wavelength"]), float(sp["max_wavelength"]), \
        int(sp["bins"])
    delta = (hi - lo) / B
    return lo + delta * 0, lo + delta * B


def compile_config(config, device="cpu", bounds=None):
    """(tables dict of float32 tensors on ``device``, Spec) of a
    configuration: one entity and one material a primitive, in the file's
    order; leaves sorted by solid type. ``bounds`` overrides the
    wavelength range (an observer's slice)."""
    sp = config["spectral"]
    lo, hi = bounds or (float(sp["min_wavelength"]),
                        float(sp["max_wavelength"]))
    B = int(sp["bins"])
    root = {"world": np.eye(4)}
    for n in config["nodes"]:
        root[n["name"]] = root[n["parent"]] @ transform_of(n["transform"])
    prims = config["primitives"]
    l2w = [root[p["parent"]] @ transform_of(p["transform"]) for p in prims]
    tid = [TYPE_SPHERE if p["shape"] == "sphere" else TYPE_BOX for p in prims]
    params = []
    for p in prims:
        blk = np.zeros(PARAM_BLOCK)
        vals = ([p["radius"]] if p["shape"] == "sphere"
                else list(p["lower"]) + list(p["upper"]))
        blk[:len(vals)] = vals
        params.append(blk)
    order = sorted(range(len(prims)), key=lambda i: (tid[i], i))
    leaf_of_entity = {e: g for g, e in enumerate(order)}

    mats = [material_rows(p["material"], lo, hi, B) for p in prims]
    leaves, kinds = [], []
    for g, e in enumerate(order):
        R3 = l2w[e][:3, :3]
        kind = 0
        if tid[e] == TYPE_SPHERE and np.abs(R3 - np.eye(3)).max() <= 1e-12:
            kind = 1
        elif tid[e] == TYPE_BOX:
            nz = np.abs(R3) > 1e-9 * max(1.0, np.abs(R3).max())
            if (nz.sum(axis=0) == 1).all() and (nz.sum(axis=1) == 1).all():
                kind = 2
        leaves.append((tid[e], e, e, kind))
    volumes = tuple((e, e, VOL_BEER, leaf_of_entity[e])
                    for e, m in enumerate(mats) if m[5] == VOL_BEER)

    imp_c, imp_r, imp_w = [], [], []
    for e, p in enumerate(prims):
        if mats[e][4] > 0.0:
            if p["shape"] == "sphere":
                c = l2w[e][:3, 3].copy()
                r = float(p["radius"]) * SPHERE_PAD
            else:
                c, r = _box_sphere(p["lower"], p["upper"], l2w[e])
            imp_c.append(c)
            imp_r.append(r)
            imp_w.append(mats[e][4])
    w = np.asarray(imp_w) / np.sum(imp_w)

    def ten(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32, device=device)

    tables = dict(
        leaf_w2l=ten([np.linalg.inv(l2w[e]) for e in order]),
        leaf_params=ten([params[e] for e in order]),
        mat_params=ten([m[1] for m in mats]),
        mat_spectra=ten([m[2] for m in mats]),
        mat_scalars=ten([m[3] for m in mats]),
        imp_centre=ten(imp_c), imp_radius=ten(imp_r), imp_weight=ten(w),
        imp_cdf=ten(np.cumsum(w)),
        entity_w2l=ten([np.linalg.inv(m) for m in l2w]))
    r = config["ray"]
    spec = Spec(
        leaves=tuple(leaves), mat_types=tuple(m[0] for m in mats),
        volumes=volumes, n_imp=len(imp_c), has_importance=bool(imp_c),
        bins=B, max_depth=int(r["max_depth"]),
        extinction_prob=float(r["extinction_prob"]),
        extinction_min_depth=int(r["extinction_min_depth"]),
        importance_sampling=bool(r["importance_sampling"]),
        important_path_weight=float(r["important_path_weight"]))
    return tables, spec
