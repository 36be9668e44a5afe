"""Scene compiler: scenegraph -> flat SoA device tensors.

This replaces the reference's scenegraph *interpreter* (World.hit walking a
kd-tree of Python primitive objects, core/scenegraph/world.pyx:125 +
core/acceleration/kdtree.pyx). The scenegraph is compiled once per (scene
version, spectral slice) into:

  * a leaf table — every analytic solid in the scene, with world<->local
    transforms and a parameter block, grouped by primitive type;
  * an entity table — the traceable objects; a simple entity maps to one
    leaf;
  * material tables — per-material-id type codes, static params, spectral
    curves baked onto the render's wavelength grid, and per-slice band
    averages (dielectric.pyx:176-177 semantics);
  * an importance table — emitter bounding spheres + sampling CDF
    (optical/scenegraph/world.pyx:88-129).

The tensors are the scene's data; structural information (counts, type
slices, static maps) is plain Python, so the tracer can derive a static
kernel descriptor from it.

Scene class of this package so far: simple analytic entities. Mesh and CSG
entities raise ``NotImplementedError``; the packed analytic-leaf BVH tables
(``leaf_bvh``) are never built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch

from ..core.scenegraph.node import World
from ..optical.material.base import (
    MAT_CONTINUOUS_BSDF,
    MAT_DISCRETE_BSDF,
    NPARAMS,
    NSCALARS,
    NSLOTS,
    VOL_NONE,
)
from ..primitive import analytic as _a
from ..primitive.shapes import OP_LEAF

__all__ = ["CompiledScene", "compile_scene", "SpectralConfig",
           "resolve_device"]


def resolve_device(device):
    """The torch.device an entry point runs on. The default is the card: a
    CUDA device that is not there raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return device


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """One spectral slice of a render (base/slice.pyx:32)."""

    min_wavelength: float
    max_wavelength: float
    bins: int

    @property
    def delta_wavelength(self):
        return (self.max_wavelength - self.min_wavelength) / self.bins


@dataclasses.dataclass
class CompiledScene:
    """Flat device-side scene: tensors plus static structure."""

    # leaves, grouped by type (type_slices static)
    leaf_w2l: Any  # f32[L,4,4]
    leaf_l2w: Any  # f32[L,4,4]
    leaf_params: Any  # f32[L,PARAM_BLOCK]
    # entities
    leaf_entity: Any  # i32[L] owning entity of each leaf
    entity_material: Any  # i32[E]
    # world->entity-local frame for EVERY entity (the primitive's own frame;
    # reference optical/ray.pyx:441-453 hands each primitive its own w2p/p2w)
    entity_w2l: Any  # f32[E,4,4]
    # materials
    mat_params: Any  # f32[M,NPARAMS]
    mat_spectra: Any  # f32[M,NSLOTS,B]
    mat_scalars: Any  # f32[M,NSCALARS]
    # importance sampling (emitter bounding spheres)
    imp_centre: Any  # f32[I,3]
    imp_radius: Any  # f32[I]
    imp_weight: Any  # f32[I] normalised weights
    imp_cdf: Any  # f32[I]
    # spectral grid: bin-centre wavelengths (nm)
    wavelengths: Any = None  # f32[B]
    # triangle meshes: always empty until the mesh path is part of this package
    meshes: Any = ()
    # packed analytic-leaf BVH planes: always None until that kernel is part
    # of this package
    leaf_bvh: Any = None

    # --- static structure ---
    # NOTE: ``leaf_fast_static`` and ``entity_material_static`` BAKE the
    # transforms / material assignment at compile time. Replacing
    # ``leaf_w2l``/``entity_material`` on a CompiledScene leaves the kernels
    # dispatching stale structure: re-run ``compile_scene`` after any
    # geometry or material-assignment change.
    type_slices: Tuple = ()
    n_leaves: int = 0
    n_entities: int = 0
    simple_leaf_of_entity: Tuple = ()
    csg_entities: Tuple = ()
    mat_types: Tuple = ()
    # static copy of entity_material (the fused bounce kernel's descriptor
    # needs each entity's material id as static structure)
    entity_material_static: Tuple = ()
    # (entity, material id, VOL_* kind, material object or None, leaf,
    #  mesh slot, trapezoid intervals)
    volume_entities: Tuple = ()
    mesh_entities: Tuple = ()
    mix_remaps: Tuple = ()
    custom_materials: Tuple = ()
    leaf_bvh_meta: Tuple = ()
    bvh_leaf_ids: Tuple = ()
    kernel_csg_entities: Tuple = ()
    # per-leaf world-space fast-record kind for the fused bounce kernel
    # (0 = general local-frame, 1 = pure-translation sphere -> world sphere,
    # 2 = axis-permutation box -> world AABB); detected from the CONCRETE
    # transforms at compile time, so it is static structure
    leaf_fast_static: Tuple = ()
    has_roughen: bool = False
    has_importance: bool = False
    n_bins: int = 15

    @property
    def bins(self):
        return self.n_bins

    @property
    def device(self):
        return self.leaf_w2l.device


def compile_scene(world: World, spectral: SpectralConfig,
                  dtype=torch.float32, device="cuda") -> CompiledScene:
    """Flatten a World scenegraph into a CompiledScene for one spectral slice."""

    if not isinstance(world, World):
        raise TypeError("compile_scene expects a World root node.")
    device = resolve_device(device)

    # --- gather leaves + entities -------------------------------------------------
    leaf_records = []  # (type_id, l2w AffineMatrix3D, params)
    entities = []  # primitive objects
    programs = []  # postfix programs with global leaf indices
    leaf_entity = []

    for prim in world.primitives:
        entity_id = len(entities)
        if getattr(prim, "is_mesh", False):
            raise NotImplementedError(
                "mesh entities need the mesh intersection path, which this "
                "package does not carry yet")
        leaf_base = len(leaf_records)
        leaves = prim.csg_leaves(prim.to_root())
        program = prim.csg_program(leaf_base)
        if not (len(program) == 1 and program[0][0] == OP_LEAF):
            raise NotImplementedError(
                "CSG entities need the streaming intersection path, which "
                "this package does not carry yet")
        entities.append(prim)
        programs.append(program)
        for leaf in leaves:
            leaf_records.append(leaf)
            leaf_entity.append(entity_id)

    n_leaves = len(leaf_records)
    n_entities = len(entities)
    if n_entities == 0:
        raise ValueError("Cannot compile an empty scene.")

    # sort leaves by type for static per-type slices; keep a stable
    # permutation so programs can be re-indexed
    order = sorted(range(n_leaves), key=lambda i: (leaf_records[i][0], i))
    remap = {old: new for new, old in enumerate(order)}
    leaf_records = [leaf_records[i] for i in order]
    leaf_entity = [leaf_entity[i] for i in order]
    simple_leaf_of_entity = [remap[prog[0][1]] for prog in programs]

    type_slices = []
    start = 0
    for t in sorted({r[0] for r in leaf_records}):
        count = sum(1 for r in leaf_records if r[0] == t)
        type_slices.append((t, start, start + count))
        start += count

    l2w = np.stack([r[1].to_array(np.float64) for r in leaf_records])
    w2l = np.stack([r[1].inverse().to_array(np.float64) for r in leaf_records])
    params = np.stack([np.asarray(r[2], dtype=np.float64) for r in leaf_records])

    # world-space fast-record detection for the fused bounce kernel
    leaf_fast = []
    for i, r in enumerate(leaf_records):
        kind = 0
        R3 = l2w[i][:3, :3]
        # only pure TRANSLATIONS — where the local-frame test (o-c exact,
        # unchanged radius) and the world-sphere test follow identical
        # float routes — take the world-sphere record; rotations and
        # scales keep general records
        if r[0] == _a.TYPE_SPHERE and np.abs(R3 - np.eye(3)).max() <= 1e-12:
            kind = 1
        elif r[0] == _a.TYPE_BOX:
            nz = np.abs(R3) > 1e-9 * max(1.0, np.abs(R3).max())
            if (nz.sum(axis=0) == 1).all() and (nz.sum(axis=1) == 1).all():
                kind = 2
        leaf_fast.append(kind)

    # --- materials -----------------------------------------------------------------
    materials = []
    mat_index = {}
    entity_material = []

    def register_material(mat):
        key = id(mat)
        if key not in mat_index:
            mat_index[key] = len(materials)
            materials.append(mat)
            for child in mat.child_materials():
                register_material(child)
        return mat_index[key]

    for prim in entities:
        mat = prim.material
        if mat is None:
            raise ValueError(
                f"Primitive {prim!r} has no material; every traceable primitive "
                "needs one (reference requires the same)."
            )
        entity_material.append(register_material(mat))

    M = len(materials)
    B = spectral.bins
    mat_types = tuple(m.MAT_TYPE for m in materials)
    mat_params = np.zeros((M, NPARAMS), dtype=np.float64)
    mat_spectra = np.zeros((M, NSLOTS, B), dtype=np.float64)
    mat_scalars = np.zeros((M, NSCALARS), dtype=np.float64)
    for i, m in enumerate(materials):
        mat_params[i] = m.compile_params()
        mat_spectra[i] = m.compile_spectra(
            spectral.min_wavelength, spectral.max_wavelength, B
        )
        mat_scalars[i] = m.compile_scalars(
            spectral.min_wavelength, spectral.max_wavelength
        )

    # mix remaps (Blend/Add modifiers): per-ray material-id reroll
    mix_remaps = []
    for i, m in enumerate(materials):
        if getattr(m, "IS_MIX", False):
            mix_remaps.append(
                (i, mat_index[id(m.m1)], mat_index[id(m.m2)], float(m.ADD_WEIGHT))
            )
    mix_remaps.sort()

    # user-extensible BSDFs: the material object is static scene structure
    custom_materials = tuple(
        (i, m) for i, m in enumerate(materials)
        if m.MAT_TYPE in (MAT_CONTINUOUS_BSDF, MAT_DISCRETE_BSDF)
    )

    # volume-active entities; the inhomogeneous kind carries its material
    # object plus a STATIC trapezoid interval count derived from the
    # reference's step rule (emitter/inhomogeneous.pyx:135-139) evaluated at
    # the compile-time chord bound — the entity's bounding-sphere diameter
    volume_entities = []
    for e, prim in enumerate(entities):
        mat = materials[entity_material[e]]
        if mat.VOLUME_KIND != VOL_NONE:
            intervals = 1
            inner = mat
            while not hasattr(inner, "integrator") and hasattr(inner, "material"):
                inner = inner.material
            integ = getattr(inner, "integrator", None)
            if integ is not None:
                _, radius = prim.bounding_sphere()
                intervals = int(min(
                    max(integ.min_samples - 1,
                        math.ceil(2.0 * float(radius) / integ.step)),
                    max(integ.max_samples - 1, integ.min_samples - 1),
                ))
            volume_entities.append((
                e, entity_material[e], mat.VOLUME_KIND, mat,
                simple_leaf_of_entity[e], -1, intervals,
            ))

    # --- importance manager (optical/scenegraph/world.pyx:88-129) ------------------
    imp_centre = []
    imp_radius = []
    imp_weight = []
    for e, prim in enumerate(entities):
        mat = materials[entity_material[e]]
        if mat.importance > 0.0:
            centre, radius = prim.bounding_sphere()
            imp_centre.append([centre.x, centre.y, centre.z])
            imp_radius.append(radius)
            imp_weight.append(mat.importance)
    has_importance = len(imp_centre) > 0
    if has_importance:
        imp_centre = np.asarray(imp_centre, dtype=np.float64)
        imp_radius = np.asarray(imp_radius, dtype=np.float64)
        w = np.asarray(imp_weight, dtype=np.float64)
        w = w / w.sum()
        imp_cdf = np.cumsum(w)
    else:
        imp_centre = np.zeros((1, 3))
        imp_radius = np.ones(1)
        w = np.ones(1)
        imp_cdf = np.ones(1)

    def ten(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return CompiledScene(
        leaf_w2l=ten(w2l),
        leaf_l2w=ten(l2w),
        leaf_params=ten(params),
        leaf_entity=ten(leaf_entity, torch.int32),
        entity_material=ten(entity_material, torch.int32),
        entity_w2l=ten(np.stack([
            p.to_root().inverse().to_array(np.float64) for p in entities
        ])),
        mat_params=ten(mat_params),
        mat_spectra=ten(mat_spectra),
        mat_scalars=ten(mat_scalars),
        imp_centre=ten(imp_centre),
        imp_radius=ten(imp_radius),
        imp_weight=ten(w),
        imp_cdf=ten(imp_cdf),
        wavelengths=ten(
            spectral.min_wavelength
            + (np.arange(B) + 0.5) * spectral.delta_wavelength),
        leaf_fast_static=tuple(leaf_fast),
        type_slices=tuple(type_slices),
        n_leaves=n_leaves,
        n_entities=n_entities,
        simple_leaf_of_entity=tuple(simple_leaf_of_entity),
        mat_types=mat_types,
        entity_material_static=tuple(entity_material),
        volume_entities=tuple(volume_entities),
        mix_remaps=tuple(mix_remaps),
        custom_materials=custom_materials,
        has_roughen=bool(
            any(m.compile_params()[7] > 0.0 for m in materials)
        ),
        has_importance=has_importance,
        n_bins=B,
    )
