"""Batched vector/transform math on [..., 3] tensors.

Counterpart of source_tpu/core/math/batch.py (itself the batched form of
raysect/core/math/{vector,point,normal,affinematrix}.pyx): every operation
acts on tensors of shape ``[..., 3]`` (or ``[..., 4, 4]`` for transforms) and
is differentiable by autograd. It carries the helpers the wavefront route
calls so far.

Geometry is written as explicit multiply-adds, never as a matrix product:
a product may run in TF32 on the card, and three decimal digits are not
enough for ray geometry (epsilon offsets break). The sums keep the
reference's association, ``(x0 + x1) + x2``.
"""

from __future__ import annotations

import torch

__all__ = [
    "dot",
    "cross",
    "length",
    "normalise",
    "orthogonal",
    "select_rows",
    "transform_point",
    "transform_vector",
    "transform_normal",
    "make_frame",
    "to_frame",
    "from_frame",
    "lerp",
    "reflect",
    "safe_sqrt",
    "safe_div",
    "safe_pow",
]


def safe_sqrt(x, min_val=0.0):
    """sqrt with a NaN-free backward at x <= min_val (double-where)."""
    ok = x > min_val
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_div(a, b, eps=1e-12):
    """a / b with a NaN-free backward when |b| <= eps (result 0 there)."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def safe_pow(base, exp):
    """base ** exp with a NaN-free backward at base <= 0 (result 0 there)."""
    ok = base > 0.0
    return torch.where(ok, torch.where(ok, base, 1.0) ** exp, 0.0)


def select_rows(table, idx):
    """``table[idx]`` with index values outside [0, L) giving zero rows (the
    reference's one-hot select; a gather on this device)."""
    L = table.shape[0]
    ok = (idx >= 0) & (idx < L)
    rows = table[torch.where(ok, idx, 0).long()]
    mask = ok.reshape(ok.shape + (1,) * (table.dim() - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=table.dtype,
                                               device=table.device))


def dot(a, b):
    """Batched 3-vector dot product: [...,3] x [...,3] -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """Batched 3-vector cross product (``jnp.cross``'s terms)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def length(v):
    """Batched vector length (NaN-free backward at zero length)."""
    return safe_sqrt(torch.sum(v * v, dim=-1))


def orthogonal(v):
    """An arbitrary unit vector orthogonal to v (vector.pyx orthogonal()):
    v crossed with the axis of its smallest-magnitude component, the first
    such axis on a tie."""
    ax = torch.abs(v)
    is_min = ax <= torch.amin(ax, dim=-1, keepdim=True)
    axis = (is_min & (torch.cumsum(is_min.to(torch.int32), dim=-1) == 1)
            ).to(v.dtype)
    return normalise(torch.linalg.cross(v, axis, dim=-1))


def normalise(v, eps=1e-24):
    """Batched safe normalise (zero vectors map to zero, finite grads)."""
    n2 = dot(v, v)[..., None]
    ok = n2 > eps
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return v * inv


def _mat3_apply(m3, v):
    """[..., 3, 3] x [..., 3] -> [..., 3] as explicit multiply-adds."""
    return (m3[..., :, 0] * v[..., 0:1] + m3[..., :, 1] * v[..., 1:2]
            + m3[..., :, 2] * v[..., 2:3])


def transform_point(m, p):
    """Affine-transform points. m: [...,4,4], p: [...,3] -> [...,3]."""
    return _mat3_apply(m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m, v):
    """Transform vectors (no translation)."""
    return _mat3_apply(m[..., :3, :3], v)


def transform_normal(m_inv, n):
    """Transform normals with the transpose of the INVERSE matrix
    (normal.pyx:38 semantics); ``m_inv`` is the inverse of the coordinate
    transform."""
    return _mat3_apply(m_inv[..., :3, :3].transpose(-1, -2), n)


def make_frame(normal):
    """Orthonormal (tangent, bitangent, normal) frame per normal
    (material.pyx:393-422), by the branchless Duff et al. construction with
    an fp-noise-tolerant sign threshold."""
    n = normal
    s = torch.where(n[..., 2] >= -1e-6, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt, n


def to_frame(v, t, b, n):
    """World -> surface frame: the components of v along (t, b, n)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def from_frame(v, t, b, n):
    """Surface -> world frame."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(d, n):
    """Mirror direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n
