"""Optical material base classes and the device compile contract.

Re-design of raysect/optical/material/material.pyx. The
reference dispatches ``evaluate_surface``/``evaluate_volume`` virtually per
intersection (material.pyx:65-115); here every material *compiles* into rows
of flat device tables and the wavefront kernel evaluates all material types
branchlessly with masked select (SURVEY.md §7 "materials become branchless
switch over material ids").

Compiled layout per material id:
  mat_type     i32                      — MAT_* code
  mat_params   f32[NPARAMS]             — static scalars (roughness, ...)
  mat_spectra  f32[NSLOTS, bins]        — spectral curves baked onto the
                                          render's wavelength grid per
                                          spectral slice
  mat_scalars  f32[NSCALARS]            — per-slice band averages (e.g. the
                                          dielectric's slice-average index,
                                          dielectric.pyx:176-177)

Slot meanings by type are documented in each subclass.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Material",
    "NullSurface",
    "NullVolume",
    "NullMaterial",
    "AbsorbingSurface",
    "MAT_ABSORBER",
    "MAT_LAMBERT",
    "MAT_EMITTER",
    "MAT_NULL",
    "MAT_CONDUCTOR",
    "MAT_ROUGH_CONDUCTOR",
    "MAT_DIELECTRIC",
    "MAT_EMITTER_ANISO",
    "MAT_CHECKERBOARD",
    "MAT_LIGHT",
    "MAT_PERFECT_REFLECT",
    "MAT_CONTINUOUS_BSDF",
    "MAT_DISCRETE_BSDF",
    "ContinuousBSDF",
    "DiscreteBSDF",
    "ROUGHEN_SLOT",
    "NPARAMS",
    "NSLOTS",
    "NSCALARS",
    "VOL_NONE",
    "VOL_BEER",
    "VOL_HOMOGENEOUS",
    "VOL_INHOMOGENEOUS",
]

MAT_ABSORBER = 0
MAT_LAMBERT = 1
MAT_EMITTER = 2
MAT_NULL = 3
MAT_CONDUCTOR = 4
MAT_ROUGH_CONDUCTOR = 5
MAT_DIELECTRIC = 6
MAT_EMITTER_ANISO = 7
MAT_CHECKERBOARD = 8
MAT_LIGHT = 9
MAT_PERFECT_REFLECT = 10
MAT_CONTINUOUS_BSDF = 11  # user subclass of ContinuousBSDF
MAT_DISCRETE_BSDF = 12  # user subclass of DiscreteBSDF

NPARAMS = 8
NSLOTS = 4
NSCALARS = 4

# params slot 7 is reserved framework-wide for the Roughen modifier's
# roughness (modifiers/roughen.pyx semantics applied pre-dispatch)
ROUGHEN_SLOT = 7

# volume interaction kinds
VOL_NONE = 0
VOL_BEER = 1  # Beer-Lambert attenuation (dielectric.pyx:313-328)
VOL_HOMOGENEOUS = 2  # constant volume emission (emitter/homogeneous.pyx:36)
VOL_INHOMOGENEOUS = 3  # ray-marched emission (emitter/inhomogeneous.pyx:108)


class Material:
    """Optical material base (material.pyx:47-115).

    ``importance`` weights the emitter for importance sampling; primitives
    carrying a material with importance > 0 are collected by the compiled
    ImportanceManager (optical/scenegraph/world.pyx:88-129).
    """

    MAT_TYPE = MAT_ABSORBER
    VOLUME_KIND = VOL_NONE

    def __init__(self):
        self._importance = 0.0
        self.primitives = []

    @property
    def importance(self):
        return self._importance

    @importance.setter
    def importance(self, value):
        if value < 0:
            raise ValueError("Material sampling importance cannot be less than zero.")
        self._importance = float(value)
        for primitive in self.primitives:
            primitive.notify_material_change()

    # --- compile contract --------------------------------------------------------

    def compile_params(self):
        """Static scalar parameters -> f32[NPARAMS]."""
        return np.zeros(NPARAMS, dtype=np.float64)

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        """Spectral curve slots baked onto the render grid -> [NSLOTS, bins]."""
        return np.zeros((NSLOTS, bins), dtype=np.float64)

    def compile_scalars(self, min_wavelength, max_wavelength):
        """Per-spectral-slice band-average scalars -> f32[NSCALARS]."""
        return np.zeros(NSCALARS, dtype=np.float64)

    def child_materials(self):
        """Materials wrapped by this one (mix modifiers); compiled into
        their own table rows and dispatched via the mix remap."""
        return []


class AbsorbingSurface(Material):
    """Perfectly absorbing terminator (absorber.pyx:37)."""

    MAT_TYPE = MAT_ABSORBER


class NullSurface(Material):
    """Pass-through surface: the ray is re-launched on the far side without
    counting a bounce (material.pyx:118-160)."""

    MAT_TYPE = MAT_NULL


class NullVolume(Material):
    """Surface-only material base: no volume response (material.pyx:163)."""

    MAT_TYPE = MAT_ABSORBER
    VOLUME_KIND = VOL_NONE


class NullMaterial(NullSurface):
    """Completely transparent material (material.pyx:196)."""

    MAT_TYPE = MAT_NULL


class ContinuousBSDF(Material):
    """User-extensible continuous BSDF (material.pyx:269-390).

    The reference exposes ``ContinuousBSDF`` as the extension point for
    materials with a full hemispheric response: subclasses supply
    ``sample``/``pdf``/``bsdf`` and the framework applies one-sample MIS
    between the BSDF proposal and the scene's important emitters
    (material.pyx:327-352). Here the same contract is *batched and
    traceable on tensors*: the wavefront kernel calls these methods on the full
    lane batch inside ``jit``, in the surface shading frame (+z = shading
    normal facing the incident ray; the incident direction ``w_in`` points
    AWAY from the surface, so ``w_in[:, 2] > 0``).

    Subclasses implement (all arguments/results tensors):

      sample(w_in, u1, u2, spectra, params, back_face) -> w_out  f32[N, 3]
          importance-sample an outgoing direction from uniforms u1, u2.
      pdf(w_in, w_out, spectra, params, back_face) -> f32[N]
          solid-angle pdf of ``sample`` producing ``w_out``.
      bsdf(w_in, w_out, wavelengths, spectra, params, back_face) -> f32[N, B]
          spectral BSDF value (1/sr) at the render's bin-centre wavelengths.

    ``spectra`` is f32[N, NSLOTS, B] (this material's compiled spectral
    slots, lane-gathered so gradients flow to the scene pytree) and
    ``params`` is f32[N, NPARAMS] from :meth:`compile_params`.
    ``back_face`` is bool[N], True where the ray is incident on the back
    side of the primitive surface (the reference's exiting/back_face flag,
    material.pyx:284-318) — materials that shade differently per side
    branch on it with ``torch.where``.

    The kernel weights the traced continuation by
    ``bsdf * |cos_out| / (w * pdf_light + (1 - w) * pdf_bsdf)`` — the
    reference's one-sample MIS estimator — and kills lanes whose combined
    pdf or cos_out is zero. Transmissive responses are supported: lanes
    whose sampled ``w_out`` lies below the surface (``w_out[:, 2] < 0``)
    relaunch on the far side of the surface, mirroring the reference's
    ``w_transmission_origin`` (material.pyx:286-361).

    NOTE: the compiled scene keys on material object *identity* — reuse the
    same material instance across ``observe()`` passes; constructing a new
    (structurally identical) instance each pass forces a full recompile.
    """

    MAT_TYPE = MAT_CONTINUOUS_BSDF

    def sample(self, w_in, u1, u2, spectra, params, back_face):
        raise NotImplementedError("ContinuousBSDF subclasses must implement sample().")

    def pdf(self, w_in, w_out, spectra, params, back_face):
        raise NotImplementedError("ContinuousBSDF subclasses must implement pdf().")

    def bsdf(self, w_in, w_out, wavelengths, spectra, params, back_face):
        raise NotImplementedError("ContinuousBSDF subclasses must implement bsdf().")


class DiscreteBSDF(Material):
    """User-extensible delta BSDF (material.pyx:205-268).

    The reference's ``DiscreteBSDF`` is the extension point for materials
    whose response is a set of delta functions (mirrors, ideal refractors):
    ``evaluate_shading`` picks the outgoing path itself. Batched contract,
    evaluated inside ``jit`` in the surface shading frame (+z = shading
    normal facing the incident ray, ``w_in`` points away from the surface):

      evaluate_shading(w_in, u, wavelengths, spectra, params, back_face) ->
          (w_out f32[N, 3] local, weight f32[N, B], transmitted bool[N])

    ``u`` is f32[N, 2] fresh uniforms for path roulette. ``weight``
    multiplies the path throughput; lanes continue while any bin of the
    weight is positive. ``transmitted`` lanes re-launch on the far side of
    the surface (refraction); others on the incident side (reflection).
    ``back_face`` is bool[N], True where the ray is incident on the back
    side of the primitive surface (material.pyx:220-268 passes the same
    flag to DiscreteBSDF.evaluate_shading).

    NOTE: reuse material instances across passes — the compiled scene keys
    on object identity and a fresh instance forces a recompile.
    """

    MAT_TYPE = MAT_DISCRETE_BSDF

    def evaluate_shading(self, w_in, u, wavelengths, spectra, params, back_face):
        raise NotImplementedError(
            "DiscreteBSDF subclasses must implement evaluate_shading()."
        )
