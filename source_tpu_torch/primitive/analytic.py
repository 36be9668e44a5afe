"""Analytic primitive constants and shared closed forms (local space).

Counterpart of the reference's per-object Cython ``hit()`` implementations
(raysect/primitive/{sphere,box,cylinder,cone,parabola,torus}.pyx). This
module carries the type codes and parameter-block layout the scene compiler
and the fused tracer share, plus the torus plug-back filter. The batched
``candidates_*/normal_*/contains_*`` functions of the streaming
intersection path are not part of this package yet; the fused tracer
(tracer/fused.py) has its own per-ray closed forms.

Local-space conventions match the reference exactly:
  - sphere: radius, centred at origin                  (sphere.pyx:45)
  - box: axis-aligned [lower, upper]                   (box.pyx:56)
  - cylinder: radius, z in [0, height], capped         (cylinder.pyx:56)
  - cone: base radius at z=0, apex z=height, capped    (cone.pyx:50)
  - parabola: base radius at z=0, vertex z=height      (parabola.pyx:51)
  - torus: major/minor radii, axis +z                  (torus.pyx:46)

Param block layout (PARAM_BLOCK = 8 floats):
  sphere   [r]
  box      [lx, ly, lz, ux, uy, uz]
  cylinder [r, h]
  cone     [r, h]
  parabola [r, h]
  torus    [R, r]
"""

from __future__ import annotations

import torch

__all__ = [
    "MAX_HITS",
    "PARAM_BLOCK",
    "TYPE_SPHERE",
    "TYPE_BOX",
    "TYPE_CYLINDER",
    "TYPE_CONE",
    "TYPE_PARABOLA",
    "TYPE_TORUS",
    "torus_root_valid",
]

MAX_HITS = 4
PARAM_BLOCK = 8

TYPE_SPHERE = 0
TYPE_BOX = 1
TYPE_CYLINDER = 2
TYPE_CONE = 3
TYPE_PARABOLA = 4
TYPE_TORUS = 5


def torus_root_valid(t, px, py, pz, R, r):
    """Plug-back filter for quartic roots: t is a genuine torus surface
    point iff the implicit residual |(|p_xy| - R)^2 + z^2 - r^2| is small
    RELATIVE to the point's magnitude. The f32 Ferrari+Newton route can
    emit pseudo-roots far from the surface (the quartic coefficients grow
    like |o|^4, so cancellation leaves |poly| ~ eps * |o|^4 ~ 0 at points
    nowhere near the torus); a legitimate polished root's residual is
    ~eps * r * |t| instead."""
    rad2 = px * px + py * py
    rad = torch.sqrt(rad2 + 1e-12)
    f = (rad - R) * (rad - R) + pz * pz - r * r
    tol = 1e-3 * (R * R + r * r + rad2 + pz * pz)
    return torch.abs(f) <= tol
