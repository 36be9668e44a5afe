"""Sampler classes: solid-angle, surface and targeted samplers.

Counterpart of source_tpu/core/math/sampler/__init__.py (the reference's
raysect/core/math/sampler/{solidangle,surface3d,targeted}.pyx). The
reference's samplers draw one sample a call from a global RNG; here each
sampler is a thin class over the pure samplers of core.math.random:
``sample(generator, n)`` draws the uniforms from ``generator`` (on its
device, else on the card) and returns n samples at once through
``from_uniforms(u)``, which callers may feed their own uniforms;
``pdf(directions)`` evaluates densities on the directions' device, and
``samples_with_pdfs`` mirrors the reference's paired API
(solidangle.pyx:42-147). A sampler's own tables (targets, triangle
vertices) are kept as one copy per device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import batch as vmath
from .. import random as vrand

__all__ = [
    "SolidAngleSampler", "SphereSampler", "HemisphereUniformSampler",
    "HemisphereCosineSampler", "ConeUniformSampler",
    "DiskSampler3D", "RectangleSampler3D", "TriangleSampler3D",
    "TargetedHemisphereSampler", "TargetedSphereSampler",
]

_PI = math.pi


class _Sampler:
    """``sample``/``samples_with_pdfs``/``__call__`` over ``from_uniforms``;
    ``n_uniforms`` uniforms a sample."""

    n_uniforms = 2

    def from_uniforms(self, u):
        """Samples [n, 3] from uniforms u [n, n_uniforms]."""
        raise NotImplementedError

    def sample(self, generator, n):
        """n samples [n, 3], drawn from ``generator``."""
        return self.from_uniforms(vrand.uniform(generator, (n, self.n_uniforms)))

    def samples_with_pdfs(self, generator, n):
        s = self.sample(generator, n)
        return s, self.pdf(s)

    def __call__(self, generator, n, pdf=False):
        if pdf:
            return self.samples_with_pdfs(generator, n)
        return self.sample(generator, n)


def _full(shape, value, like):
    return torch.full(shape, value, dtype=torch.float32, device=like.device)


class SolidAngleSampler(_Sampler):
    """Direction-distribution base (solidangle.pyx:42)."""

    def pdf(self, directions):
        """Probability density per direction [..., 3] -> [...]."""
        raise NotImplementedError


class SphereSampler(SolidAngleSampler):
    """Uniform over the full sphere (solidangle.pyx:149)."""

    def from_uniforms(self, u):
        return vrand.vector_sphere(u[:, 0], u[:, 1])

    def pdf(self, directions):
        return _full(directions.shape[:-1], 1.0 / (4.0 * _PI), directions)


class HemisphereUniformSampler(SolidAngleSampler):
    """Uniform over the +z hemisphere (solidangle.pyx:176)."""

    def from_uniforms(self, u):
        return vrand.vector_hemisphere_uniform(u[:, 0], u[:, 1])

    def pdf(self, directions):
        return torch.where(directions[..., 2] >= 0.0, 1.0 / (2.0 * _PI), 0.0)


class HemisphereCosineSampler(SolidAngleSampler):
    """Cosine-weighted +z hemisphere (solidangle.pyx:208)."""

    def from_uniforms(self, u):
        return vrand.vector_hemisphere_cosine(u[:, 0], u[:, 1])

    def pdf(self, directions):
        z = directions[..., 2]
        return torch.where(z >= 0.0, z / _PI, 0.0)


class ConeUniformSampler(SolidAngleSampler):
    """Uniform in a cone of half-angle ``angle`` degrees about +z
    (solidangle.pyx:240)."""

    def __init__(self, angle=45.0):
        if not 0 < angle <= 90.0:
            raise ValueError("The cone angle must lie in (0, 90] degrees.")
        self.angle = float(angle)
        # the cosine in float32, as the JAX package takes it
        self._cos_max = float(torch.cos(torch.deg2rad(
            torch.tensor(angle, dtype=torch.float32))))

    def from_uniforms(self, u):
        return vrand.vector_cone_uniform(u[:, 0], u[:, 1], self._cos_max)

    def pdf(self, directions):
        solid_angle = 2.0 * _PI * (1.0 - self._cos_max)
        return torch.where(directions[..., 2] >= self._cos_max,
                           1.0 / solid_angle, 0.0)


# --- surface point samplers (surface3d.pyx) -----------------------------------


class _SurfaceSampler3D(_Sampler):
    """Point-distribution base: points [n, 3] with pdf = 1/area
    (surface3d.pyx:38)."""

    area = None

    def pdf(self, points=None, n=1):
        """1/area at each point [..., 3] (on their device), or n times on
        the card."""
        if points is not None:
            return _full(points.shape[:-1], 1.0 / self.area, points)
        from ....compiler.scene import resolve_device

        return torch.full((n,), 1.0 / self.area, dtype=torch.float32,
                          device=resolve_device("cuda"))


class DiskSampler3D(_SurfaceSampler3D):
    """Uniform over a disk in the z=0 plane (surface3d.pyx:136)."""

    def __init__(self, radius=1.0):
        if radius <= 0:
            raise ValueError("radius must be positive.")
        self.radius = float(radius)
        self.area = _PI * radius * radius

    def from_uniforms(self, u):
        return vrand.point_disk(u[:, 0], u[:, 1], self.radius)


class RectangleSampler3D(_SurfaceSampler3D):
    """Uniform over a centred rectangle in the z=0 plane
    (surface3d.pyx:169)."""

    def __init__(self, width=1.0, height=1.0):
        if width <= 0 or height <= 0:
            raise ValueError("width and height must be positive.")
        self.width = float(width)
        self.height = float(height)
        self.area = width * height

    def from_uniforms(self, u):
        return vrand.point_rectangle(u[:, 0], u[:, 1], self.width, self.height)


class _Tables:
    """A sampler's float32 tables, one copy per device."""

    def __init__(self, **arrays):
        self._host = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
                      for k, v in arrays.items()}
        self._by_device = {torch.device("cpu"): self._host}

    def on(self, device):
        device = torch.device(device)
        tabs = self._by_device.get(device)
        if tabs is None:
            tabs = {k: v.to(device) for k, v in self._host.items()}
            self._by_device[device] = tabs
        return tabs


def _xyz(v):
    return [v.x, v.y, v.z] if hasattr(v, "x") else list(v)


class TriangleSampler3D(_SurfaceSampler3D):
    """Uniform over a 3D triangle (surface3d.pyx:205)."""

    def __init__(self, v1, v2, v3):
        self._tables = _Tables(v1=_xyz(v1), v2=_xyz(v2), v3=_xyz(v3))
        t = self._tables.on("cpu")
        self.v1, self.v2, self.v3 = t["v1"], t["v2"], t["v3"]
        self.area = float(0.5 * torch.linalg.vector_norm(torch.linalg.cross(
            self.v2 - self.v1, self.v3 - self.v1, dim=-1)))

    def from_uniforms(self, u):
        t = self._tables.on(u.device)
        return vrand.point_triangle(u[:, 0], u[:, 1], t["v1"], t["v2"], t["v3"])


# --- targeted samplers (targeted.pyx:41-440) ------------------------------------


class _TargetedSampler(SolidAngleSampler):
    """Mixture of cone samplers aimed at weighted target spheres plus a
    fallback ambient distribution (targeted.pyx:41: CDF over targets, cone
    sampling, mixture pdf). Targets are (centre[3], radius, weight) tuples;
    the origin is fixed per sampler instance (the reference passes it per
    call)."""

    n_uniforms = 4
    # fraction of samples sent to targets vs ambient
    targeted_path_prob = 0.9

    def __init__(self, targets, origin=(0.0, 0.0, 0.0)):
        if not targets:
            raise ValueError("At least one target sphere is required.")
        centres, radii, weights = [], [], []
        for centre, radius, weight in targets:
            if radius <= 0:
                raise ValueError("Target sphere radius must be positive.")
            if weight <= 0:
                raise ValueError("Target weight must be positive.")
            centres.append(_xyz(centre))
            radii.append(radius)
            weights.append(weight)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        self._tables = _Tables(origin=_xyz(origin), centre=centres,
                               radius=radii, weight=w, cdf=np.cumsum(w))
        self.origin = self._tables.on("cpu")["origin"]

    def _cones(self, t):
        to_c = t["centre"] - t["origin"][None, :]
        dist = torch.sqrt(torch.sum(to_c * to_c, dim=-1) + 1e-30)
        axis = to_c / dist[:, None]
        sin2 = torch.clamp((t["radius"] / dist) ** 2, 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
        cos_max = torch.where(dist <= t["radius"], -1.0, cos_max)
        return axis, cos_max

    def _ambient_sample(self, u1, u2):
        raise NotImplementedError

    def _ambient_pdf(self, directions):
        raise NotImplementedError

    def from_uniforms(self, u):
        t = self._tables.on(u.device)
        axis, cos_max = self._cones(t)
        cdf = t["cdf"]
        idx = torch.clamp(torch.searchsorted(cdf, u[:, 0].contiguous()), 0,
                          cdf.shape[0] - 1)
        local = vrand.vector_cone_uniform(u[:, 1], u[:, 2], cos_max[idx])
        tt, b, nrm = vmath.make_frame(axis[idx])
        cone_dir = vmath.from_frame(local, tt, b, nrm)
        amb = self._ambient_sample(u[:, 1], u[:, 2])
        pick_cone = u[:, 3] < self.targeted_path_prob
        return torch.where(pick_cone[:, None], cone_dir, amb)

    def pdf(self, directions):
        t = self._tables.on(directions.device)
        axis, cos_max = self._cones(t)
        cos_to = torch.sum(directions[..., None, :] * axis, dim=-1)  # [..., T]
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        cone_pdf = torch.where(cos_to >= cos_max,
                               1.0 / torch.clamp(solid_angle, min=1e-12), 0.0)
        mix = torch.sum(t["weight"] * cone_pdf, dim=-1)
        p = self.targeted_path_prob
        return p * mix + (1.0 - p) * self._ambient_pdf(directions)


class TargetedHemisphereSampler(_TargetedSampler):
    """Targeted sampling over the +z hemisphere (targeted.pyx:251): the
    ambient fallback is cosine-weighted; directions below the horizon get
    zero pdf."""

    def _ambient_sample(self, u1, u2):
        return vrand.vector_hemisphere_cosine(u1, u2)

    def _ambient_pdf(self, directions):
        z = directions[..., 2]
        return torch.where(z >= 0.0, z / _PI, 0.0)

    def pdf(self, directions):
        base = super().pdf(directions)
        return torch.where(directions[..., 2] >= 0.0, base, 0.0)


class TargetedSphereSampler(_TargetedSampler):
    """Targeted sampling over the full sphere (targeted.pyx:392): the
    ambient fallback is the uniform sphere."""

    def _ambient_sample(self, u1, u2):
        return vrand.vector_sphere(u1, u2)

    def _ambient_pdf(self, directions):
        return _full(directions.shape[:-1], 1.0 / (4.0 * _PI), directions)
