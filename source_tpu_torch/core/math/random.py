"""Random draws and solid-angle and surface samplers on tensors.

Counterpart of the reference's core/math/random.py (itself the TPU
replacement of raysect/core/math/random.pyx:31-308). The reference derives
keys with ``jax.random``; here every draw takes an explicit
``torch.Generator`` (a draw lands on its device, or on ``device=``, else
on the card), and the samplers are pure
functions of their uniforms, so callers choose where the uniforms come
from (parity tests hand in the reference's).

The vector samplers mirror random.pyx's ``vector_sphere``,
``vector_hemisphere_uniform``, ``vector_hemisphere_cosine`` and
``vector_cone_uniform`` with the pdf conventions of the SolidAngleSampler
classes (core/math/sampler/solidangle.pyx:42-283).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "uniform",
    "normal",
    "probability",
    "vector_sphere",
    "vector_hemisphere_uniform",
    "vector_hemisphere_cosine",
    "vector_cone_uniform",
    "vector_cone_cosine",
    "point_disk",
    "point_square",
    "point_rectangle",
    "point_triangle",
    "pdf_sphere",
    "pdf_hemisphere_uniform",
    "pdf_hemisphere_cosine",
    "pdf_cone_uniform",
]

_2PI = 2.0 * math.pi
_R4PI = 1.0 / (4.0 * math.pi)
_R2PI = 1.0 / (2.0 * math.pi)
_RPI = 1.0 / math.pi


def _safe_sqrt(x):
    ok = x > 0.0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _device(generator, device):
    """Where a draw lands: ``device``, else the generator's device, else
    the card (raising where there is none, as the JAX package draws on its
    default device)."""
    if device is not None:
        return device
    if generator is not None:
        return generator.device
    from ...compiler.scene import resolve_device

    return resolve_device("cuda")


def uniform(generator=None, shape=(), device=None):
    """U[0, 1) f32 samples (random.pyx:247) from ``generator``."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=_device(generator, device))


def normal(generator=None, mean=0.0, stddev=1.0, shape=(), device=None):
    """Gaussian f32 samples (random.pyx:273) from ``generator``."""
    return mean + stddev * torch.randn(
        shape, generator=generator, dtype=torch.float32,
        device=_device(generator, device))


def probability(generator=None, prob=0.5, shape=(), device=None):
    """True with probability ``prob`` (random.pyx:308)."""
    return uniform(generator, shape, device) < prob


# --- solid angle samplers ---------------------------------------------------
# Every sampler takes uniform pairs u1, u2 in [0, 1).


def _polar(r, phi, z):
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def vector_sphere(u1, u2):
    """Uniform direction on the full sphere. pdf = 1/(4 pi)."""
    z = 1.0 - 2.0 * u1
    return _polar(_safe_sqrt(1.0 - z * z), _2PI * u2, z)


def vector_hemisphere_uniform(u1, u2):
    """Uniform direction on the +z hemisphere. pdf = 1/(2 pi)."""
    z = u1
    return _polar(_safe_sqrt(1.0 - z * z), _2PI * u2, z)


def vector_hemisphere_cosine(u1, u2):
    """Cosine-weighted direction on the +z hemisphere. pdf = cos(theta)/pi."""
    z2 = u1
    return _polar(_safe_sqrt(1.0 - z2), _2PI * u2, _safe_sqrt(z2))


def vector_cone_uniform(u1, u2, cos_max):
    """Uniform direction in a cone of half-angle acos(cos_max) about +z.
    pdf = 1 / (2 pi (1 - cos_max)) (solidangle.pyx ConeUniformSampler:240)."""
    z = 1.0 - u1 * (1.0 - cos_max)
    return _polar(_safe_sqrt(1.0 - z * z), _2PI * u2, z)


def vector_cone_cosine(u1, u2, cos_max):
    """Cosine-weighted direction in a cone about +z."""
    z2 = 1.0 - u1 * (1.0 - cos_max * cos_max)
    return _polar(_safe_sqrt(1.0 - z2), _2PI * u2, _safe_sqrt(z2))


def pdf_sphere(d=None):
    return _R4PI


def pdf_hemisphere_uniform(d):
    """pdf of a +z-frame direction d [..., 3]."""
    return torch.where(d[..., 2] >= 0.0, _R2PI, 0.0)


def pdf_hemisphere_cosine(d):
    return torch.clamp(d[..., 2], min=0.0) * _RPI


def pdf_cone_uniform(d, cos_max):
    inside = d[..., 2] >= cos_max
    one_minus = torch.clamp(torch.as_tensor(1.0 - cos_max, dtype=d.dtype,
                                            device=d.device), min=1e-12)
    return torch.where(inside, 1.0 / (_2PI * one_minus), 0.0)


# --- surface point samplers (sampler/surface3d.pyx) --------------------------


def point_disk(u1, u2, radius=1.0):
    """Uniform point on a disk in the z=0 plane (DiskSampler3D:136)."""
    r = radius * torch.sqrt(u1)
    return _polar(r, _2PI * u2, torch.zeros_like(r))


def point_square(u1, u2, width=1.0):
    """Uniform point on an axis-aligned square centred at the origin, z=0."""
    return torch.stack(
        [(u1 - 0.5) * width, (u2 - 0.5) * width, torch.zeros_like(u1)], dim=-1)


def point_rectangle(u1, u2, width, height):
    """Uniform point on a rectangle centred at the origin, z=0
    (RectangleSampler3D:169)."""
    return torch.stack(
        [(u1 - 0.5) * width, (u2 - 0.5) * height, torch.zeros_like(u1)], dim=-1)


def point_triangle(u1, u2, v1, v2, v3):
    """Uniform point on triangle (v1, v2, v3) (TriangleSampler3D:205)."""
    su1 = torch.sqrt(u1)
    b0 = 1.0 - su1
    b1 = u2 * su1
    b2 = 1.0 - b0 - b1
    return b0[..., None] * v1 + b1[..., None] * v2 + b2[..., None] * v3
