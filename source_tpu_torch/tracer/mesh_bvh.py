"""The mesh nearest-hit kernel: build, load, launch.

``mesh_bvh_winner`` launches csrc/mesh_bvh.cu, the hand-written CUDA kernel
that replaces both TPU mesh kernels of the JAX package,
source_tpu/tracer/pallas_mesh.py:192 ``_kernel`` (K7, a mesh whose packed
tables fit the TPU's VMEM) and :369 ``_paged_kernel`` (K8, the same hit for a
larger mesh cut into pages with private BVHs). Paging exists because the
tables do not fit VMEM; on the card a 1.31M-triangle mesh's tables (tens of
MB) sit in device memory and largely in the 50 MB L2, so both are one
traversal over one BVH. The TPU's ray->page sort has no counterpart: on an
H100 a coherence sort of the rays (``analytic_bvh._coherence_order`` on the
mesh's root box) takes longer than it saves the kernel on the 1.31M-triangle
mesh (``chip_smoke.py``, phase ``mesh_kernels``; PERF.md, Findings), so the
wrapper launches on the rays in the callers' order.

Its plain version, and the specification, is
``meshtrace.mesh_intersect_plain``; the entry point that routes CPU tensors
to it and carries the gradient is ``meshtrace.mesh_intersect``.
"""

from __future__ import annotations

import ctypes

import torch

from . import fused as _f

__all__ = ["mesh_bvh_winner", "build_library"]

_library = None


def build_library(verbose=False):
    """Compile csrc/mesh_bvh.cu into ``_build/`` (if the source is newer than
    the library); returns (library path, compiler log)."""
    return _f.nvcc_build("mesh_bvh.cu", (), "libmesh_bvh.so", (), verbose)


def _lib():
    global _library
    if _library is None:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # o, d, t_min, t_max (or NULL), N, vertices, triangles, node_lo,
        # node_hi, node_skip, node_first, node_count, n_nodes, out t, tri,
        # u, v, front, stream
        lib.mesh_bvh_winner.argtypes = [p, p, p, p, i] + [p] * 7 + [i] + [p] * 6
        lib.mesh_bvh_winner.restype = i
        _library = lib
    return _library


def _launch(mesh, o, d, t_min, t_max=None):
    """One launch on rays in the order given; raw records (front as i32)."""
    N = o.shape[0]
    dev = o.device
    f32 = [("origin", o), ("direction", d), ("t_min", t_min),
           ("vertices", mesh.vertices), ("node_lo", mesh.node_lo),
           ("node_hi", mesh.node_hi)]
    if t_max is not None:
        f32.append(("t_max", t_max))
    i32 = [("triangles", mesh.triangles), ("node_skip", mesh.node_skip),
           ("node_first", mesh.node_first), ("node_count", mesh.node_count)]
    for dtype, group in ((torch.float32, f32), (torch.int32, i32)):
        for name, t in group:
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name}: want a contiguous {dtype} tensor "
                                 f"on {dev}")
    if (tuple(o.shape) != (N, 3) or tuple(d.shape) != (N, 3)
            or tuple(t_min.shape) != (N,)
            or (t_max is not None and tuple(t_max.shape) != (N,))):
        raise ValueError("rays must be [N,3], t_min and t_max [N]")
    if tuple(mesh.node_lo.shape) != (mesh.n_nodes, 3):
        raise ValueError("mesh node tables do not match n_nodes")
    out = {"t": torch.empty(N, dtype=torch.float32, device=dev),
           "tri": torch.empty(N, dtype=torch.int32, device=dev),
           "u": torch.empty(N, dtype=torch.float32, device=dev),
           "v": torch.empty(N, dtype=torch.float32, device=dev),
           "front": torch.empty(N, dtype=torch.int32, device=dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().mesh_bvh_winner(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            None if t_max is None else t_max.data_ptr(), N,
            mesh.vertices.data_ptr(), mesh.triangles.data_ptr(),
            mesh.node_lo.data_ptr(), mesh.node_hi.data_ptr(),
            mesh.node_skip.data_ptr(), mesh.node_first.data_ptr(),
            mesh.node_count.data_ptr(), int(mesh.n_nodes),
            *[out[k].data_ptr() for k in ("t", "tri", "u", "v", "front")],
            stream)
    if err != 0:
        raise RuntimeError(f"mesh_bvh_winner: CUDA launch failed with error "
                           f"{err}")
    mesh_bvh_winner.launches += 1
    return out


def mesh_bvh_winner(mesh, origin, direction, t_min, t_max=None):
    """Nearest hit of CUDA rays on one mesh by the kernel: t, tri, u, v,
    front as ``meshtrace.mesh_intersect`` returns them. Raises for tensors
    not on a CUDA device (the plain version is
    ``meshtrace.mesh_intersect_plain``)."""
    if not origin.is_cuda:
        raise ValueError("mesh_bvh_winner launches the CUDA kernel: the rays "
                         "must be CUDA tensors")
    out = _launch(mesh, origin, direction, t_min, t_max)
    out["front"] = out["front"] > 0
    return out


mesh_bvh_winner.launches = 0
