"""Camera ray generators on tensors.

Counterparts of the reference's optical/observer/cameras.py (the imaging
observers' ``_generate_rays``, optical/observer/imaging/*.pyx). Each maps
(pixel indices, uniforms) -> (origin, direction, weight) in camera-local
space; the observer takes them to world space with its scenegraph
transform.
"""

from __future__ import annotations

import math

import torch

from ...core.math import batch as vmath
from ...core.math import random as vrand

__all__ = [
    "pinhole_geometry",
    "pinhole_rays",
    "orthographic_rays",
    "ccd_rays",
    "vector_camera_rays",
]


def pinhole_geometry(nx, ny, fov):
    """Image-plane geometry (pinhole.pyx:148-166)."""
    max_pixels = max(nx, ny)
    if max_pixels <= 1:
        raise RuntimeError("Number of Pinhole camera pixels must be > 1.")
    image_max_width = 2.0 * math.tan(math.pi / 180.0 * 0.5 * fov)
    image_delta = image_max_width / max_pixels
    image_start_x = 0.5 * nx * image_delta
    image_start_y = 0.5 * ny * image_delta
    return image_delta, image_start_x, image_start_y


def _jittered(px, py, u1, u2, delta, sx, sy, dtype):
    """Jittered image-plane point of each pixel sample."""
    x = sx - delta * (px.to(dtype) + 0.5) + (u1 - 0.5) * delta
    y = sy - delta * (py.to(dtype) + 0.5) + (u2 - 0.5) * delta
    return x, y


def pinhole_rays(px, py, u1, u2, nx, ny, fov, dtype=torch.float32):
    """Pinhole rays for pixel indices px/py with jitter uniforms u1/u2.

    PinholeCamera._generate_rays (pinhole.pyx:168-200): origin at the
    aperture, direction through a jittered point of the virtual image plane
    at z=1; radiometric weight = direction.z (projected-area cosine).
    """
    delta, sx, sy = pinhole_geometry(nx, ny, fov)
    x, y = _jittered(px, py, u1, u2, delta, sx, sy, dtype)
    direction = vmath.normalise(torch.stack([x, y, torch.ones_like(x)], dim=-1))
    origin = torch.zeros_like(direction)
    weight = direction[..., 2]
    return origin, direction, weight


def orthographic_rays(px, py, u1, u2, nx, ny, width, dtype=torch.float32):
    """Parallel-projection rays (orthographic.pyx:41): origins on the sensor
    plane, direction +z, unit weight."""
    delta = width / max(nx, ny)
    ox, oy = _jittered(px, py, u1, u2, delta, 0.5 * nx * delta,
                       0.5 * ny * delta, dtype)
    ox, oy = torch.broadcast_tensors(ox, oy)
    origin = torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)
    direction = torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                             device=origin.device).expand(origin.shape)
    weight = torch.ones_like(ox)
    return origin, direction, weight


def ccd_rays(px, py, u, nx, ny, width, dtype=torch.float32):
    """Physical CCD rays (ccd.pyx:42-110): jittered origin on the sensor and
    cosine-weighted hemisphere directions; the observer applies the
    etendue-correct sensitivity. ``u`` is [..., 4] uniforms."""
    delta = width / nx
    ox, oy = _jittered(px, py, u[..., 0], u[..., 1], delta, 0.5 * nx * delta,
                       0.5 * ny * delta, dtype)
    origin = torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)
    direction = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
    weight = torch.ones_like(ox)
    return origin, direction, weight


def vector_camera_rays(px, py, origins, directions, dtype=torch.float32):
    """Calibrated per-pixel rays (vector.pyx:44-75): the given origin and
    direction tables gathered at the pixel indices."""
    origin = origins[px, py]
    direction = directions[px, py]
    weight = torch.ones(px.shape, dtype=dtype, device=origin.device)
    return origin, direction, weight
