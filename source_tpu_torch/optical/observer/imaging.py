"""Imaging observers (cameras).

Counterparts of the reference's optical/observer/imaging.py
(raysect/optical/observer/imaging/{pinhole,orthographic,ccd,vector,opencv,
targeted_ccd}.pyx). Each camera supplies a batched ray generator on
tensors; spectral slicing, tiling, tracing and statistics live in
Observer2D.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.math import batch as vmath
from ...core.math import random as vrand
from .base import Observer2D
from .cameras import ccd_rays, orthographic_rays, pinhole_rays
from .pipelines import RGBPipeline2D

__all__ = [
    "PinholeCamera",
    "OrthographicCamera",
    "CCDArray",
    "VectorCamera",
    "OpenCVCamera",
    "TargetedCCDArray",
]


def _rgb(pipelines):
    return pipelines if pipelines is not None else [RGBPipeline2D()]


class PinholeCamera(Observer2D):
    """Ideal pinhole camera (imaging/pinhole.pyx:42). ``fov`` is the angle
    across the horizontal field of view in degrees."""

    _rays_per_sample = 2

    def __init__(self, pixels=(512, 512), fov=45.0, sensitivity=1.0,
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None, render_engine=None, device="cuda"):
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=_rgb(pipelines),
            parent=parent, transform=transform, name=name,
            render_engine=render_engine, device=device,
        )
        self._fov = None
        self._sensitivity = None
        self.fov = fov
        self.sensitivity = sensitivity

    @property
    def fov(self):
        return self._fov

    @fov.setter
    def fov(self, value):
        if value <= 0 or value >= 180:
            raise ValueError("The field-of-view angle must lie in the range (0, 180).")
        self._fov = float(value)

    @property
    def sensitivity(self):
        return self._sensitivity

    @sensitivity.setter
    def sensitivity(self, value):
        if value <= 0:
            raise ValueError("Sensitivity must be greater than zero.")
        self._sensitivity = float(value)

    def _pixel_sensitivity_array(self):
        return np.full(self.pixels[0] * self.pixels[1], self._sensitivity, np.float32)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        return pinhole_rays(px, py, u[..., 0], u[..., 1], nx, ny, self._fov)


class OrthographicCamera(Observer2D):
    """Parallel projection camera (imaging/orthographic.pyx:41)."""

    _rays_per_sample = 2

    def __init__(self, pixels=(512, 512), width=1.0, sensitivity=1.0,
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None, render_engine=None, device="cuda"):
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=_rgb(pipelines),
            parent=parent, transform=transform, name=name,
            render_engine=render_engine, device=device,
        )
        self._width = None
        self.width = width
        self.sensitivity = float(sensitivity)

    @property
    def width(self):
        return self._width

    @width.setter
    def width(self, value):
        if value <= 0:
            raise ValueError("Width must be greater than zero.")
        self._width = float(value)

    def _pixel_sensitivity_array(self):
        return np.full(self.pixels[0] * self.pixels[1], self.sensitivity, np.float32)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        return orthographic_rays(px, py, u[..., 0], u[..., 1], nx, ny, self._width)


class CCDArray(Observer2D):
    """Physically modelled CCD sensor array (imaging/ccd.pyx:42). Pixels
    observe a cosine-weighted hemisphere; the etendue-correct sensitivity
    pi * A_pixel makes PowerPipelines read W."""

    _rays_per_sample = 4

    def __init__(self, pixels=(720, 480), width=0.035, frame_sampler=None,
                 pipelines=None, parent=None, transform=None, name=None,
                 render_engine=None, device="cuda"):
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=_rgb(pipelines),
            parent=parent, transform=transform, name=name,
            render_engine=render_engine, device=device,
        )
        self._width = None
        self.width = width

    @property
    def width(self):
        return self._width

    @width.setter
    def width(self, value):
        if value <= 0:
            raise ValueError("Width must be greater than zero.")
        self._width = float(value)
        self._pixel_area = (self._width / self.pixels[0]) ** 2

    def _pixel_sensitivity_array(self):
        # etendue: pi * A (the cosine-weighted hemisphere integral of cos)
        return np.full(self.pixels[0] * self.pixels[1],
                       math.pi * self._pixel_area, np.float32)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        return ccd_rays(px, py, u, nx, ny, self._width)


class VectorCamera(Observer2D):
    """Calibrated per-pixel ray camera (imaging/vector.pyx:44)."""

    _rays_per_sample = 2

    def __init__(self, pixel_origins, pixel_directions, frame_sampler=None,
                 pipelines=None, parent=None, transform=None, name=None,
                 device="cuda"):
        pixel_origins = np.asarray(pixel_origins, np.float32)
        pixel_directions = np.asarray(pixel_directions, np.float32)
        if (pixel_origins.shape != pixel_directions.shape
                or pixel_origins.ndim != 3 or pixel_origins.shape[-1] != 3):
            raise ValueError("Origin and direction arrays must both be [nx, ny, 3].")
        super().__init__(
            pixels=pixel_origins.shape[:2], frame_sampler=frame_sampler,
            pipelines=_rgb(pipelines), parent=parent, transform=transform,
            name=name, device=device,
        )
        self.pixel_origins = torch.from_numpy(pixel_origins)
        self.pixel_directions = torch.from_numpy(pixel_directions)

    def _generate_rays_device(self, px, py, u):
        # the per-pixel rays broadcast over the sample axis (px/py are
        # [T, 1]; u carries the [T, spp] sample shape)
        shape = u.shape[:-1]
        o = self.pixel_origins.to(u.device)[px, py].expand(shape + (3,))
        d = self.pixel_directions.to(u.device)[px, py].expand(shape + (3,))
        w = torch.ones(shape, dtype=torch.float32, device=u.device)
        return o, d, w


class OpenCVCamera(Observer2D):
    """Camera-matrix + distortion calibrated camera (imaging/opencv.pyx:43).

    ``camera_matrix`` is the OpenCV 3x3 intrinsic matrix [[fx,0,cx],
    [0,fy,cy],[0,0,1]] in pixel units, ``distortion`` the 5-vector
    (k1, k2, p1, p2, k3). A pixel maps to normalised coordinates, the
    radial/tangential distortion is inverted by a fixed-point iteration,
    and the ray leaves the aperture through the undistorted point.
    """

    _rays_per_sample = 2

    def __init__(self, camera_matrix, distortion=None, pixels=(640, 480),
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None, device="cuda"):
        camera_matrix = np.asarray(camera_matrix, np.float64)
        if camera_matrix.shape != (3, 3):
            raise ValueError("camera_matrix must be 3x3.")
        distortion = (np.zeros(5) if distortion is None
                      else np.asarray(distortion, np.float64).reshape(-1))
        if distortion.shape[0] not in (4, 5):
            raise ValueError("distortion must have 4 or 5 coefficients.")
        if distortion.shape[0] == 4:
            distortion = np.concatenate([distortion, [0.0]])
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=_rgb(pipelines),
            parent=parent, transform=transform, name=name, device=device,
        )
        self.camera_matrix = camera_matrix
        self.distortion = distortion

    def _generate_rays_device(self, px, py, u):
        fx = float(self.camera_matrix[0, 0])
        fy = float(self.camera_matrix[1, 1])
        cx = float(self.camera_matrix[0, 2])
        cy = float(self.camera_matrix[1, 2])
        k1, k2, p1, p2, k3 = (float(v) for v in self.distortion)
        # jittered distorted pixel -> normalised camera coordinates
        xd = (px.to(torch.float32) + u[..., 0] - cx) / fx
        yd = (py.to(torch.float32) + u[..., 1] - cy) / fy
        # invert the distortion by fixed-point iteration (x = xd / D(x))
        x, y = xd, yd
        for _ in range(5):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        direction = vmath.normalise(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        origin = torch.zeros_like(direction)
        weight = direction[..., 2]
        return origin, direction, weight


class TargetedCCDArray(CCDArray):
    """CCD with directions aimed at named primitives
    (imaging/targeted_ccd.pyx:46): a share of samples takes a uniform cone
    at one target's bounding sphere, the rest the cosine hemisphere, each
    weighted by the mixture pdf (one-sample MIS)."""

    _rays_per_sample = 6

    def __init__(self, targets, targeted_path_prob=0.9, **kwargs):
        super().__init__(**kwargs)
        if not targets:
            raise ValueError("At least one target primitive is required.")
        if not 0 < targeted_path_prob <= 1:
            raise ValueError("targeted_path_prob must lie in (0, 1].")
        self.targets = list(targets)
        self.targeted_path_prob = float(targeted_path_prob)

    def _targets_local(self):
        out = []
        for t in self.targets:
            centre, radius = t.bounding_sphere()
            c = centre.transform(self.to_local())
            out.append((c.x, c.y, c.z, radius))
        return tuple(out)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        origin, _, _ = ccd_rays(px, py, u, nx, ny, self._width)
        targets = torch.tensor(self._targets_local(), dtype=torch.float32,
                               device=u.device)  # [K, 4]
        K = targets.shape[0]
        to_c = targets[:, :3] - origin[..., None, :]  # [..., K, 3]
        dist = torch.sqrt(torch.sum(to_c * to_c, dim=-1) + 1e-30)
        axis = to_c / dist[..., None]
        radius = targets[:, 3]
        sin2 = torch.clamp((radius / dist) ** 2, 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
        cos_max = torch.where(dist <= radius, -1.0, cos_max)

        # pick a target uniformly, then sample its cone
        t_idx = torch.clamp((u[..., 4] * K).to(torch.int64), 0, K - 1)
        ax = torch.take_along_dim(axis, t_idx[..., None, None], dim=-2)[..., 0, :]
        cm = torch.take_along_dim(cos_max, t_idx[..., None], dim=-1)[..., 0]
        local_cone = vrand.vector_cone_uniform(u[..., 2], u[..., 3], cm)
        t_f, b_f, n_f = vmath.make_frame(ax)
        d_cone = vmath.from_frame(local_cone, t_f, b_f, n_f)
        d_cos = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        p = self.targeted_path_prob
        direction = torch.where((u[..., 5] < p)[..., None], d_cone, d_cos)

        # mixture pdf over all targets and the hemisphere
        pdf_cos = torch.clamp(direction[..., 2], 0.0, 1.0) / math.pi
        cos_to = torch.sum(direction[..., None, :] * axis, dim=-1)  # [..., K]
        solid_angle = 2.0 * math.pi * (1.0 - cos_max)
        pdf_cone_k = torch.where(
            cos_to >= cos_max, 1.0 / torch.clamp(solid_angle, min=1e-12), 0.0)
        pdf = p * torch.mean(pdf_cone_k, dim=-1) + (1.0 - p) * pdf_cos
        ok = (pdf > 1e-12) & (direction[..., 2] > 0.0)
        weight = torch.where(ok, pdf_cos / torch.clamp(pdf, min=1e-12), 0.0)
        return origin, direction, weight
