"""Carry a compiled scene across from plain arrays.

``scene_from_numpy`` rebuilds a ``CompiledScene`` from the array fields and
static fields of a scene compiled elsewhere (for instance by the JAX
package, after ``np.asarray`` on its side), so both packages can trace the
same scene — including scenes whose host classes this package does not
carry yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler.scene import CompiledScene, resolve_device

__all__ = ["scene_from_numpy", "ARRAY_FIELDS", "STATIC_FIELDS"]

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
    "has_roughen", "has_importance", "n_bins",
)


def scene_from_numpy(arrays: dict, static: dict, device="cuda"):
    """CompiledScene from ``arrays`` (name -> numpy array, ARRAY_FIELDS) and
    ``static`` (name -> plain Python value, STATIC_FIELDS). Rows of
    ``volume_entities`` carry ``None`` in place of the material object."""
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

    def frozen(v):
        return tuple(frozen(x) for x in v) if isinstance(v, (list, tuple)) else v

    return CompiledScene(**tensors,
                         **{k: frozen(static[k]) for k in STATIC_FIELDS})
