"""Mesh file IO: OBJ / STL (ascii+binary) / PLY (ascii+binary) / VTK legacy /
RSM.

Counterpart of source_tpu/primitive/mesh/io.py (the reference's
raysect/primitive/mesh/{obj,stl,ply,vtk}.py and mesh.pyx:864-1046):
``import_*`` return a Mesh primitive, ``export_*`` write the file from a
Mesh. Host-side numpy load paths, no device code. The OBJ reader is a native
tokenizer (``csrc/meshio.cpp``, this package's copy of the JAX package's),
compiled with g++ at the first OBJ import into ``_build/``; the Python reader
is the fallback when no compiler is there.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from .mesh import Mesh

__all__ = [
    "import_obj", "export_obj",
    "import_stl", "export_stl",
    "import_ply", "export_ply",
    "import_vtk", "export_vtk",
    "import_rsm", "export_rsm",
    "STL_ASCII", "STL_BINARY", "STL_AUTOMATIC",
    "PLY_ASCII", "PLY_BINARY", "PLY_AUTOMATIC",
    "VTK_ASCII", "VTK_BINARY", "VTK_AUTOMATIC",
]

# Export mode constants (reference primitive/mesh/{stl,ply,vtk}.py module
# globals). AUTOMATIC resolves to the compact binary form.
STL_ASCII = PLY_ASCII = VTK_ASCII = "ascii"
STL_BINARY = PLY_BINARY = VTK_BINARY = "binary"
STL_AUTOMATIC = PLY_AUTOMATIC = VTK_AUTOMATIC = "automatic"

_PKG = Path(__file__).resolve().parent.parent.parent
_SRC = _PKG / "csrc" / "meshio.cpp"
_BUILD = _PKG / "_build"
_LIB_LOCK = threading.Lock()
_MESHIO_LIB = None
_MESHIO_FAILED = False


def _mesh_kwargs(kwargs):
    mesh_keys = ("parent", "transform", "material", "name", "smoothing",
                 "closed", "flip_normals")
    return {k: v for k, v in kwargs.items() if k in mesh_keys}


# --- OBJ (obj.py:39,146) ------------------------------------------------------


def _load_meshio():
    """The native OBJ tokenizer, compiled at first use (the lock, the
    temp-and-rename and the flags of accel/bvh.py); None without g++."""
    global _MESHIO_LIB, _MESHIO_FAILED
    with _LIB_LOCK:
        if _MESHIO_LIB is not None or _MESHIO_FAILED:
            return _MESHIO_LIB
        lib_path = _BUILD / "libmeshio.so"
        try:
            if (not lib_path.exists()
                    or lib_path.stat().st_mtime < _SRC.stat().st_mtime):
                _BUILD.mkdir(exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.obj_count.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
            lib.obj_count.restype = ctypes.c_int
            lib.obj_read.argtypes = [ctypes.c_char_p, f32p, f32p, i32p, i32p]
            lib.obj_read.restype = ctypes.c_int
            _MESHIO_LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _MESHIO_FAILED = True
        return _MESHIO_LIB


def _import_obj_native(path, scaling, **kwargs):
    """Native two-pass OBJ load; None when the library is absent."""
    lib = _load_meshio()
    if lib is None:
        return None
    path = os.fspath(path)
    nv, nn, nt = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.obj_count(path.encode(), ctypes.byref(nv), ctypes.byref(nn),
                     ctypes.byref(nt)) != 0:
        raise IOError(f"Cannot open OBJ file {path!r}.")
    vertices = np.empty((nv.value, 3), np.float32)
    normals = np.empty((max(nn.value, 1), 3), np.float32)
    triangles = np.empty((nt.value, 3), np.int32)
    tri_normals = np.empty((nt.value, 3), np.int32)
    status = lib.obj_read(path.encode(), vertices, normals, triangles,
                          tri_normals)
    if status < 0:
        raise IOError(f"Failed to parse OBJ file {path!r}.")
    vertices *= scaling
    if status == 1 and nn.value:
        tris6 = np.concatenate([triangles, tri_normals], axis=1)
        return Mesh(vertices, tris6, normals=normals, **_mesh_kwargs(kwargs))
    return Mesh(vertices, triangles, **_mesh_kwargs(kwargs))


def import_obj(path, scaling=1.0, **kwargs):
    """Load a Wavefront OBJ file (v/vn/f records; polygons fan-triangulated)
    with the native tokenizer, or the Python reader without g++."""
    mesh = _import_obj_native(path, scaling, **kwargs)
    if mesh is not None:
        return mesh
    return _import_obj_python(path, scaling, **kwargs)


def _import_obj_python(path, scaling=1.0, **kwargs):
    vertices, normals, faces, face_normal_ids = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx, nidx = [], []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    idx.append(int(comps[0]) - 1)
                    if len(comps) >= 3 and comps[2]:
                        nidx.append(int(comps[2]) - 1)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if len(nidx) == len(idx):
                        face_normal_ids.append([nidx[0], nidx[k], nidx[k + 1]])
    vertices = np.asarray(vertices, np.float32) * scaling
    triangles = np.asarray(faces, np.int32)
    normals_arr = None
    if normals and len(face_normal_ids) == len(faces):
        triangles = np.concatenate(
            [triangles, np.asarray(face_normal_ids, np.int32)], axis=1)
        normals_arr = np.asarray(normals, np.float32)
    return Mesh(vertices, triangles, normals=normals_arr, **_mesh_kwargs(kwargs))


def export_obj(mesh, path, comment="exported by source_tpu"):
    d = mesh.data
    with open(path, "w") as f:
        f.write(f"# {comment}\n")
        for v in d.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for n in d.vertex_normals:
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for t in d.triangles:
            f.write(
                f"f {t[0]+1}//{t[0]+1} {t[1]+1}//{t[1]+1} {t[2]+1}//{t[2]+1}\n")


# --- STL (stl.py:43,204) ------------------------------------------------------


def import_stl(path, scaling=1.0, **kwargs):
    """Load an STL file (auto-detects ascii vs binary)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        try:
            return _import_stl_ascii(path, scaling, **kwargs)
        except ValueError:
            pass  # some binary files start with 'solid'
    return _import_stl_binary(path, scaling, **kwargs)


def _import_stl_ascii(path, scaling, **kwargs):
    tri_pts = []
    with open(path) as f:
        current = []
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "vertex":
                current.append([float(x) for x in parts[1:4]])
            elif parts[0] == "endfacet":
                if len(current) != 3:
                    raise ValueError("Malformed ascii STL facet.")
                tri_pts.append(current)
                current = []
    if not tri_pts:
        raise ValueError("No facets found (probably binary STL).")
    return _mesh_from_soup(np.asarray(tri_pts, np.float32) * scaling, **kwargs)


def _import_stl_binary(path, scaling, **kwargs):
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tri = data[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    return _mesh_from_soup(tri.astype(np.float32) * scaling, **kwargs)


def _mesh_from_soup(tri_pts, **kwargs):
    """Weld duplicate vertices of a triangle soup [T,3,3] -> indexed mesh."""
    flat = tri_pts.reshape(-1, 3)
    uniq, inverse = np.unique(flat.round(decimals=6), axis=0,
                              return_inverse=True)
    triangles = inverse.reshape(-1, 3).astype(np.int32)
    return Mesh(uniq.astype(np.float32), triangles, **_mesh_kwargs(kwargs))


def _export_mode(mode, fmt):
    if mode not in ("ascii", "binary", "automatic"):
        raise ValueError(f"Unsupported {fmt} export mode {mode!r}.")
    return "binary" if mode == "automatic" else mode


def export_stl(mesh, path, mode=STL_AUTOMATIC):
    mode = _export_mode(mode, "STL")
    d = mesh.data
    v, t, fn = d.vertices, d.triangles, d.face_normals
    if mode == "ascii":
        with open(path, "w") as f:
            f.write("solid source_tpu\n")
            for i in range(len(t)):
                f.write(f" facet normal {fn[i,0]} {fn[i,1]} {fn[i,2]}\n"
                        "  outer loop\n")
                for c in range(3):
                    p = v[t[i, c]]
                    f.write(f"   vertex {p[0]} {p[1]} {p[2]}\n")
                f.write("  endloop\n endfacet\n")
            f.write("endsolid source_tpu\n")
    else:
        # one 50-byte record a facet: normal, three vertices, attribute 0
        rec = np.zeros(len(t), np.dtype([("f", "<f4", (12,)), ("a", "<u2")]))
        rec["f"] = np.concatenate(
            [fn, v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]], axis=1)
        with open(path, "wb") as f:
            f.write(b"\0" * 80)
            f.write(struct.pack("<I", len(t)))
            f.write(rec.tobytes())


# --- PLY (ply.py:47) ----------------------------------------------------------

_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "uchar": "<u1", "uint8": "<u1", "char": "<i1", "short": "<i2",
              "ushort": "<u2", "int": "<i4", "uint": "<u4", "int32": "<i4"}


def import_ply(path, scaling=1.0, **kwargs):
    """Load a PLY file (ascii or binary_little_endian, vertex xyz + faces)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("Not a PLY file.")
        fmt = None
        counts = {}
        vertex_props = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("PLY header has no end_header.")
            line = line.split()
            if not line:
                continue
            if line[0] == b"format":
                fmt = line[1].decode()
            elif line[0] == b"element":
                name = line[1].decode()
                counts[name] = int(line[2])
                in_vertex = name == "vertex"
            elif line[0] == b"property" and in_vertex and line[1] != b"list":
                vertex_props.append((line[2].decode(), line[1].decode()))
            elif line[0] == b"end_header":
                break
        nv = counts.get("vertex", 0)
        nf = counts.get("face", 0)
        faces = []
        if fmt == "ascii":
            verts = []
            for _ in range(nv):
                vals = f.readline().split()
                verts.append([float(vals[i]) for i in range(3)])
            for _ in range(nf):
                vals = [int(x) for x in f.readline().split()]
                n = vals[0]
                poly = vals[1:1 + n]
                for k in range(1, n - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
        elif fmt == "binary_little_endian":
            vdt = np.dtype([(nm, _PLY_TYPES[tp]) for nm, tp in vertex_props])
            raw = np.frombuffer(f.read(nv * vdt.itemsize), dtype=vdt)
            verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=-1)
            for _ in range(nf):
                (n,) = struct.unpack("<B", f.read(1))
                poly = struct.unpack(f"<{n}i", f.read(4 * n))
                for k in range(1, n - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
        else:
            raise ValueError(f"Unsupported PLY format {fmt!r}.")
    vertices = np.asarray(verts, np.float32) * scaling
    return Mesh(vertices, np.asarray(faces, np.int32), **_mesh_kwargs(kwargs))


def export_ply(mesh, path, mode=PLY_AUTOMATIC, comment="exported by source_tpu"):
    mode = _export_mode(mode, "PLY")
    d = mesh.data
    with open(path, "wb") as f:
        fmt = "ascii 1.0" if mode == "ascii" else "binary_little_endian 1.0"
        hdr = (
            f"ply\nformat {fmt}\n"
            f"comment {comment}\n"
            f"element vertex {d.n_vertices}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {d.n_triangles}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(hdr.encode())
        if mode == "ascii":
            for v in d.vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
            for t in d.triangles:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
        else:
            f.write(d.vertices.astype("<f4").tobytes())
            # one 13-byte record a face: the count 3, then three int32 ids
            rec = np.zeros(d.n_triangles, np.dtype([("n", "<u1"),
                                                    ("ids", "<i4", (3,))]))
            rec["n"] = 3
            rec["ids"] = d.triangles
            f.write(rec.tobytes())


# --- VTK legacy (vtk.py:49) ---------------------------------------------------


def import_vtk(path, scaling=1.0, **kwargs):
    """Load a legacy-format ascii VTK POLYDATA file."""
    with open(path) as f:
        tokens = f.read().split()
    verts, faces = None, []
    i = 0
    while i < len(tokens):
        tok = tokens[i].upper()
        if tok == "POINTS":
            n = int(tokens[i + 1])
            vals = [float(tokens[i + 3 + k]) for k in range(3 * n)]
            verts = np.asarray(vals, np.float32).reshape(n, 3)
            i += 3 + 3 * n
        elif tok == "POLYGONS":
            n = int(tokens[i + 1])
            i += 3
            for _ in range(n):
                c = int(tokens[i])
                poly = [int(tokens[i + 1 + k]) for k in range(c)]
                for k in range(1, c - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
                i += 1 + c
        else:
            i += 1
    if verts is None:
        raise ValueError("No POINTS block found in VTK file.")
    return Mesh(verts * scaling, np.asarray(faces, np.int32),
                **_mesh_kwargs(kwargs))


def export_vtk(mesh, path, comment="exported by source_tpu"):
    d = mesh.data
    with open(path, "w") as f:
        f.write(f"# vtk DataFile Version 2.0\n{comment}\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {d.n_vertices} float\n")
        for v in d.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        f.write(f"POLYGONS {d.n_triangles} {4 * d.n_triangles}\n")
        for t in d.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


# --- RSM: the reference's binary mesh format (mesh.pyx:864-1046) ----------------


def import_rsm(path, **kwargs):
    """Load a Raysect .rsm binary mesh file (mesh.pyx:936-1028 layout).

    The embedded kd-tree (the reference serialises its built accelerator,
    kdtree3d.pyx:864-912) is parsed and discarded, as the JAX package does:
    the BVH is built anew from the geometry."""
    with open(path, "rb") as f:
        if f.read(3) != b"RSM":
            raise ValueError("Specified file is not a Raysect mesh file.")
        major, minor = struct.unpack("<BB", f.read(2))
        if major != 1:
            raise ValueError(f"Unsupported Raysect mesh version {major}.{minor}.")
        smoothing, closed, _has_kdtree = struct.unpack("<???", f.read(3))
        nv, nn, nt = struct.unpack("<iii", f.read(12))
        vertices = np.frombuffer(f.read(12 * nv), "<f4").reshape(nv, 3)
        normals = None
        if nn > 0:
            normals = np.frombuffer(f.read(12 * nn), "<f4").reshape(nn, 3)
        width = 6 if nn > 0 else 3
        triangles = np.frombuffer(f.read(4 * width * nt), "<i4").reshape(nt, width)
    kwargs.setdefault("smoothing", bool(smoothing))
    kwargs.setdefault("closed", bool(closed))
    # per-triangle normal ids (columns 3:6) become per-vertex normals where
    # they are the identity mapping; otherwise the normals are recomputed
    vertex_normals = None
    if normals is not None and triangles.shape[1] == 6:
        if np.array_equal(triangles[:, :3], triangles[:, 3:6]) and nn == nv:
            vertex_normals = normals
        triangles = triangles[:, :3]
    return Mesh(np.ascontiguousarray(vertices), np.ascontiguousarray(triangles),
                normals=vertex_normals, **_mesh_kwargs(kwargs))


def export_rsm(mesh, path):
    """Write a Raysect-loadable .rsm binary mesh file.

    Geometry follows mesh.pyx:888-928; the mandatory kd-tree section is
    written as a single root LEAF holding every triangle (a valid, if
    unaccelerated, reference kd-tree; ``import_rsm`` skips the section)."""
    d = mesh.data
    v = np.asarray(d.vertices, "<f4")
    t = np.asarray(d.triangles, "<i4")
    vn = d.vertex_normals
    nv, nt = v.shape[0], t.shape[0]
    nn = 0 if vn is None else np.asarray(vn).shape[0]
    with open(path, "wb") as f:
        f.write(b"RSM")
        f.write(struct.pack("<BB", 1, 0))
        f.write(struct.pack("<???", bool(d.smoothing), bool(d.closed), True))
        f.write(struct.pack("<iii", nv, nn, nt))
        f.write(v.tobytes())
        if nn:
            f.write(np.asarray(vn, "<f4").tobytes())
            f.write(np.concatenate([t, t], axis=1).astype("<i4").tobytes())
        else:
            f.write(t.tobytes())
        # kd-tree header (kdtree3d.pyx:877-892): depth/min_items/hit_cost/
        # empty_bonus, world bounds, then one LEAF node with all items
        lo, hi = d.local_aabb()
        f.write(struct.pack("<ii", 0, 1))
        f.write(struct.pack("<dd", 20.0, 0.2))
        f.write(struct.pack("<ddd", *[float(x) for x in lo]))
        f.write(struct.pack("<ddd", *[float(x) for x in hi]))
        f.write(struct.pack("<i", 1))  # node count
        f.write(struct.pack("<ii", -1, nt))  # LEAF, item count
        f.write(np.arange(nt, dtype="<i4").tobytes())
