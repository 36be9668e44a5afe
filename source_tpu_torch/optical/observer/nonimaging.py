"""Non-imaging observers: Pixel, SightLine, FibreOptic, TargetedPixel,
MeshPixel, MeshCamera.

Counterparts of the reference's optical/observer/nonimaging.py
(raysect/optical/observer/nonimaging/{pixel,sightline,fibreoptic,
targeted_pixel,mesh_pixel,mesh_camera}.pyx). Each is a batched ray
generator on tensors over the Observer0D/1D machinery; etendue factors are
per-pixel sensitivities, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.math import batch as vmath
from ...core.math import random as vrand
from .base import Observer0D, Observer1D
from .pipelines import PowerPipeline0D

__all__ = [
    "Pixel", "SightLine", "FibreOptic", "TargetedPixel",
    "MeshPixel", "MeshCamera",
]

_PI = math.pi


def _default_pipelines(p):
    return p if p is not None else [PowerPipeline0D()]


def _pixel_origin(u, x_width, y_width):
    """Uniform points on an x_width by y_width rectangle at z=0."""
    return torch.stack([(u[..., 0] - 0.5) * x_width,
                        (u[..., 1] - 0.5) * y_width,
                        torch.zeros_like(u[..., 0])], dim=-1)


class Pixel(Observer0D):
    """Rectangular collecting surface with cosine-hemisphere acceptance
    (nonimaging/pixel.pyx:41,152). Sensitivity = area * pi (the etendue of
    a cosine-weighted hemisphere over the pixel)."""

    _rays_per_sample = 4

    def __init__(self, x_width=0.01, y_width=0.01, pipelines=None, parent=None,
                 transform=None, name=None, device="cuda"):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name, device=device)
        if x_width <= 0 or y_width <= 0:
            raise ValueError("Pixel dimensions must be greater than zero.")
        self.x_width = float(x_width)
        self.y_width = float(y_width)

    @property
    def etendue(self):
        return self.x_width * self.y_width * _PI

    @property
    def collection_area(self):
        return self.x_width * self.y_width

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        origin = _pixel_origin(u, self.x_width, self.y_width)
        direction = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        return origin, direction, torch.ones_like(u[..., 0])


class SightLine(Observer0D):
    """Single line of sight along +z (nonimaging/sightline.pyx:39): measures
    radiance directly."""

    _rays_per_sample = 2

    def __init__(self, sensitivity=1.0, pipelines=None, parent=None,
                 transform=None, name=None, device="cuda"):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name, device=device)
        if sensitivity <= 0:
            raise ValueError("Sensitivity must be greater than zero.")
        self.sensitivity = float(sensitivity)

    def _pixel_sensitivity_array(self):
        return np.asarray([self.sensitivity], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        z = torch.zeros_like(u[..., 0])
        origin = torch.stack([z, z, z], dim=-1)
        direction = torch.stack([z, z, torch.ones_like(z)], dim=-1)
        return origin, direction, torch.ones_like(z)


class FibreOptic(Observer0D):
    """Optical fibre: circular core with a cone acceptance
    (nonimaging/fibreoptic.pyx:48). Uniform-cone directions carry a
    cos(theta) weight; sensitivity = core area * cone solid angle."""

    _rays_per_sample = 4

    def __init__(self, acceptance_angle=5.0, radius=0.001, pipelines=None,
                 parent=None, transform=None, name=None, device="cuda"):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name, device=device)
        if not 0 < acceptance_angle <= 90:
            raise ValueError("Acceptance angle must lie in (0, 90] degrees.")
        if radius <= 0:
            raise ValueError("Fibre radius must be greater than zero.")
        self.acceptance_angle = float(acceptance_angle)
        self.radius = float(radius)
        self._cos_max = math.cos(math.radians(acceptance_angle))

    @property
    def solid_angle(self):
        return 2.0 * _PI * (1.0 - self._cos_max)

    @property
    def collection_area(self):
        return _PI * self.radius * self.radius

    @property
    def etendue(self):
        return self.collection_area * self.solid_angle

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        origin = vrand.point_disk(u[..., 0], u[..., 1], self.radius)
        direction = vrand.vector_cone_uniform(u[..., 2], u[..., 3], self._cos_max)
        return origin, direction, direction[..., 2]  # cos(theta) weight


class TargetedPixel(Observer0D):
    """Pixel whose directions aim at a primitive's bounding sphere
    (nonimaging/targeted_pixel.pyx:45): with probability
    ``targeted_path_prob`` a uniform-cone sample towards the target, else a
    cosine-hemisphere sample, both weighted by the mixture pdf (one-sample
    MIS)."""

    _rays_per_sample = 6

    def __init__(self, target, x_width=0.01, y_width=0.01,
                 targeted_path_prob=0.9, pipelines=None, parent=None,
                 transform=None, name=None, device="cuda"):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name, device=device)
        if x_width <= 0 or y_width <= 0:
            raise ValueError("Pixel dimensions must be greater than zero.")
        if not 0 < targeted_path_prob <= 1:
            raise ValueError("targeted_path_prob must lie in (0, 1].")
        self.target = target
        self.x_width = float(x_width)
        self.y_width = float(y_width)
        self.targeted_path_prob = float(targeted_path_prob)

    @property
    def etendue(self):
        return self.x_width * self.y_width * _PI

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _target_sphere_local(self):
        """The target's bounding sphere in this observer's local frame."""
        centre, radius = self.target.bounding_sphere()
        c_local = centre.transform(self.to_local())
        return (c_local.x, c_local.y, c_local.z, radius)

    def _generate_rays_device(self, px, py, u):
        cx, cy, cz, radius = self._target_sphere_local()
        origin = _pixel_origin(u, self.x_width, self.y_width)
        centre = torch.tensor([cx, cy, cz], dtype=origin.dtype,
                              device=origin.device)
        to_c = centre - origin
        dist = torch.sqrt(torch.sum(to_c * to_c, dim=-1) + 1e-30)
        axis = to_c / dist[..., None]
        sin2 = torch.clamp((radius / dist) ** 2, 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
        cos_max = torch.where(dist <= radius, -1.0, cos_max)

        # candidate directions
        local_cone = vrand.vector_cone_uniform(u[..., 2], u[..., 3], cos_max)
        t_f, b_f, n_f = vmath.make_frame(axis)
        d_cone = vmath.from_frame(local_cone, t_f, b_f, n_f)
        d_cos = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        p = self.targeted_path_prob
        direction = torch.where((u[..., 4] < p)[..., None], d_cone, d_cos)

        # mixture pdf at the chosen direction
        pdf_cos = torch.clamp(direction[..., 2], 0.0, 1.0) / _PI
        cos_to_axis = torch.sum(direction * axis, dim=-1)
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        pdf_cone = torch.where(
            cos_to_axis >= cos_max, 1.0 / torch.clamp(solid_angle, min=1e-12), 0.0)
        pdf = p * pdf_cone + (1.0 - p) * pdf_cos
        ok = (pdf > 1e-12) & (direction[..., 2] > 0.0)
        # (cos/pi) / pdf restores the cosine-hemisphere measure that the
        # etendue sensitivity assumes
        weight = torch.where(ok, pdf_cos / torch.clamp(pdf, min=1e-12), 0.0)
        return origin, direction, weight


class _MeshSurfaceSampler:
    """Area-weighted triangle sampling over a MeshData (host tables, moved
    to a device on first use there)."""

    def __init__(self, mesh_data):
        d = mesh_data
        v0 = d.vertices[d.triangles[:, 0]]
        v1 = d.vertices[d.triangles[:, 1]]
        v2 = d.vertices[d.triangles[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        self.total_area = float(areas.sum())
        cdf = np.cumsum(areas)
        self.areas = areas
        self._host = {
            "cdf": torch.from_numpy((cdf / cdf[-1]).astype(np.float32)),
            "v0": torch.from_numpy(np.ascontiguousarray(v0, np.float32)),
            "v1": torch.from_numpy(np.ascontiguousarray(v1, np.float32)),
            "v2": torch.from_numpy(np.ascontiguousarray(v2, np.float32)),
            "normals": torch.from_numpy(
                np.ascontiguousarray(d.face_normals, np.float32)),
        }
        self._on = {}

    def tables(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[device]

    def sample(self, tri, u1, u2, u3, u4, offset, device):
        """Points on triangles ``tri`` (area-uniform within each) and
        cosine-hemisphere directions about their face normals."""
        tab = self.tables(device)
        p = vrand.point_triangle(u1, u2, tab["v0"][tri], tab["v1"][tri],
                                 tab["v2"][tri])
        n = tab["normals"][tri]
        t_f, b_f, n_f = vmath.make_frame(n)
        d_local = vrand.vector_hemisphere_cosine(u3, u4)
        direction = vmath.from_frame(d_local, t_f, b_f, n_f)
        return p + n * offset, direction


class MeshPixel(Observer0D):
    """Observe from a mesh surface (nonimaging/mesh_pixel.pyx:61): points
    area-uniform over all triangles, cosine-hemisphere directions about the
    face normal. Sensitivity = total area * pi."""

    _rays_per_sample = 5

    def __init__(self, mesh_data, surface_offset=1e-6, pipelines=None,
                 parent=None, transform=None, name=None, device="cuda"):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name, device=device)
        self._sampler = _MeshSurfaceSampler(mesh_data)
        self.surface_offset = float(surface_offset)

    @property
    def collection_area(self):
        return self._sampler.total_area

    @property
    def etendue(self):
        return self._sampler.total_area * _PI

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        cdf = self._sampler.tables(u.device)["cdf"]
        tri = torch.clamp(
            torch.searchsorted(cdf, u[..., 0].contiguous(), side="left"),
            0, cdf.shape[0] - 1)
        origin, direction = self._sampler.sample(
            tri, u[..., 1], u[..., 2], u[..., 3], u[..., 4],
            self.surface_offset, u.device)
        return origin, direction, torch.ones_like(u[..., 0])


class MeshCamera(Observer1D):
    """Per-triangle observer (nonimaging/mesh_camera.pyx:61): pixel i
    collects from triangle i of the mesh (area-etendue sensitivity per
    triangle)."""

    _rays_per_sample = 4

    def __init__(self, mesh_data, surface_offset=1e-6, pipelines=None,
                 frame_sampler=None, parent=None, transform=None, name=None,
                 device="cuda"):
        sampler = _MeshSurfaceSampler(mesh_data)
        super().__init__(
            pixels=int(sampler.areas.shape[0]), frame_sampler=frame_sampler,
            pipelines=_default_pipelines(pipelines), parent=parent,
            transform=transform, name=name, device=device,
        )
        self._sampler = sampler
        self.surface_offset = float(surface_offset)

    def _pixel_sensitivity_array(self):
        return (self._sampler.areas * _PI).astype(np.float32)

    def _generate_rays_device(self, px, py, u):
        tri = torch.clamp(px, 0, self.pixels - 1).expand(u[..., 0].shape)
        origin, direction = self._sampler.sample(
            tri, u[..., 0], u[..., 1], u[..., 2], u[..., 3],
            self.surface_offset, u.device)
        return origin, direction, torch.ones_like(u[..., 0])
