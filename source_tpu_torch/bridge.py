"""Carry a compiled scene across from plain arrays.

``scene_from_numpy`` rebuilds a ``CompiledScene`` from the array fields and
static fields of a scene compiled elsewhere (for instance by the JAX
package, after ``np.asarray`` on its side), so both packages can trace the
same scene — including scenes whose host classes this package does not
carry yet. The packed analytic-BVH tables come across too (``arrays`` key
``"leaf_bvh"``: a dict of the "nodes", "leaves" and "csg" arrays, or None),
so both packages intersect through the same tree. So do the meshes
(``arrays`` key ``"meshes"``: one dict per mesh of the MESH_ARRAYS as numpy
arrays and the MESH_STATIC as plain values); the JAX package's TPU packing
of a mesh is not carried. A scene's user BSDFs and inhomogeneous volume
emitters are code, written once in each package in its own array library:
``materials`` hands this package's objects for those material rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler.scene import CompiledScene, resolve_device
from .optical.material.base import VOL_INHOMOGENEOUS
from .tracer.meshtrace import MeshTables

__all__ = ["scene_from_numpy", "ARRAY_FIELDS", "STATIC_FIELDS", "BVH_TABLES",
           "MESH_ARRAYS", "MESH_STATIC"]

ARRAY_FIELDS = (
    "leaf_w2l", "leaf_l2w", "leaf_params", "leaf_entity", "entity_material",
    "entity_w2l", "mat_params", "mat_spectra", "mat_scalars", "imp_centre",
    "imp_radius", "imp_weight", "imp_cdf", "wavelengths",
)
_INT_FIELDS = ("leaf_entity", "entity_material")
STATIC_FIELDS = (
    "type_slices", "n_leaves", "n_entities", "simple_leaf_of_entity",
    "csg_entities", "mat_types", "entity_material_static", "volume_entities",
    "mesh_entities", "mix_remaps", "custom_materials", "leaf_fast_static",
    "has_roughen", "has_importance", "n_bins", "leaf_bvh_meta",
    "bvh_leaf_ids", "kernel_csg_entities",
)
BVH_TABLES = ("nodes", "leaves", "csg")
MESH_ARRAYS = ("vertices", "triangles", "face_normals", "vertex_normals",
               "node_lo", "node_hi", "node_skip", "node_first", "node_count",
               "w2l", "l2w")
_MESH_INT = ("triangles", "node_skip", "node_first", "node_count")
MESH_STATIC = ("n_nodes", "max_leaf", "smoothing", "closed")


def scene_from_numpy(arrays: dict, static: dict, device="cuda",
                     materials=None):
    """CompiledScene from ``arrays`` (name -> numpy array, ARRAY_FIELDS) and
    ``static`` (name -> plain Python value, STATIC_FIELDS), and the BVH
    tables under ``arrays["leaf_bvh"]`` and the meshes under
    ``arrays["meshes"]`` when the scene has them.

    ``materials`` maps a material index to this package's material object
    for that row: it takes the place of the object in the rows of
    ``custom_materials`` and ``volume_entities`` (whose static values may
    hold another package's objects, or ``None``). Every row of
    ``custom_materials`` and every inhomogeneous volume needs one: the
    tracer calls their methods."""
    device = resolve_device(device)
    missing = [k for k in ARRAY_FIELDS if k not in arrays]
    missing += [k for k in STATIC_FIELDS if k not in static]
    if missing:
        raise KeyError(f"scene_from_numpy: missing fields {missing}")
    tensors = {
        k: torch.as_tensor(
            np.array(arrays[k]),
            dtype=torch.int32 if k in _INT_FIELDS else torch.float32,
        ).to(device)
        for k in ARRAY_FIELDS
    }

    bvh = arrays.get("leaf_bvh")
    if bvh is not None:
        bvh = {k: torch.as_tensor(np.array(bvh[k]), dtype=torch.float32)
               .to(device) for k in BVH_TABLES}

    meshes = tuple(MeshTables(
        **{k: torch.as_tensor(
            np.array(m[k]),
            dtype=torch.int32 if k in _MESH_INT else torch.float32).to(device)
           for k in MESH_ARRAYS},
        **{k: m[k] for k in MESH_STATIC}) for m in arrays.get("meshes", ()))

    def frozen(v):
        return tuple(frozen(x) for x in v) if isinstance(v, (list, tuple)) else v

    fields = {k: frozen(static[k]) for k in STATIC_FIELDS}
    materials = dict(materials or {})
    need = ([i for i, _ in fields["custom_materials"]]
            + [r[1] for r in fields["volume_entities"]
               if r[2] == VOL_INHOMOGENEOUS])
    missing = sorted(set(need) - set(materials))
    if missing:
        raise KeyError(f"scene_from_numpy: materials= has no object for the "
                       f"user BSDF or inhomogeneous volume rows {missing}")
    fields["custom_materials"] = tuple(
        (i, materials[i]) for i, _ in fields["custom_materials"])
    fields["volume_entities"] = tuple(
        r[:3] + (materials.get(r[1], r[3]),) + r[4:]
        for r in fields["volume_entities"])
    return CompiledScene(**tensors, leaf_bvh=bvh, meshes=meshes, **fields)
