"""Material modifiers: Roughen, Blend, Add, VolumeTransform.

Counterparts of raysect/optical/material/modifiers/ (roughen.pyx:46-120,
blend.pyx:37, add.pyx:36, transform.pyx:36), and of the JAX package's
``optical/material/modifiers.py``. The reference wraps materials with
delegating ``evaluate_surface`` overrides; in the flat-table dispatch:

  * ``Roughen`` compiles as its base material's row with the reserved
    roughness slot set: the wavefront route perturbs the shading normal
    before the material dispatch (a lerp toward a cosine-hemisphere sample,
    four rejection tries);
  * ``Blend``/``Add`` compile their children as rows of their own plus a
    remap row: per ray, the surface stage rolls the mix before gathering the
    material's rows. ``Add`` picks each child with probability 1/2 and
    doubles the response, an unbiased one-sample estimator of the sum (the
    reference traces both daughters: the same expectation, a little more
    variance);
  * ``VolumeTransform`` composes an extra affine transform into the wrapped
    material's volume-integration frame (transform.pyx:36).
"""

from __future__ import annotations

import numpy as np

from .base import NPARAMS, ROUGHEN_SLOT, Material

__all__ = ["Roughen", "Blend", "Add", "VolumeTransform"]


class _Delegating(Material):
    """Delegation shared by the wrapping modifiers."""

    def __init__(self, material):
        super().__init__()
        self.material = material

    @property
    def MAT_TYPE(self):  # noqa: N802 -- the class attribute's name
        return self.material.MAT_TYPE

    @property
    def VOLUME_KIND(self):  # noqa: N802
        return self.material.VOLUME_KIND

    def compile_params(self):
        return self.material.compile_params()

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        return self.material.compile_spectra(min_wavelength, max_wavelength,
                                             bins)

    def compile_scalars(self, min_wavelength, max_wavelength):
        return self.material.compile_scalars(min_wavelength, max_wavelength)

    def child_materials(self):
        return self.material.child_materials()


class Roughen(_Delegating):
    """Perturb the wrapped material's shading normal (roughen.pyx:46).

    ``roughness`` in [0, 1]: 0 leaves the normal, 1 resamples it over the
    whole cosine hemisphere.
    """

    def __init__(self, material, roughness):
        if not 0 <= roughness <= 1:
            raise ValueError("roughness must lie in [0, 1].")
        super().__init__(material)
        self.roughness = float(roughness)

    def compile_params(self):
        p = np.array(self.material.compile_params(), dtype=np.float64)
        p[ROUGHEN_SLOT] = self.roughness
        return p


class _Mix(Material):
    """Base of the two-material mixes. Compiles as a remap row whose
    params[0] is the probability of picking material 2."""

    IS_MIX = True
    ADD_WEIGHT = 1.0  # throughput compensation of the mixed lanes

    def __init__(self, m1, m2, prob_m2):
        super().__init__()
        self.m1 = m1
        self.m2 = m2
        self._prob_m2 = float(prob_m2)

    def child_materials(self):
        return [self.m1, self.m2]

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = self._prob_m2
        return p


class Blend(_Mix):
    """Probabilistic blend of two materials (blend.pyx:37): each interaction
    takes material 2 with probability ``ratio``, else material 1; the
    roulette weights cancel, so no compensation applies."""

    def __init__(self, m1, m2, ratio, surface_only=False, volume_only=False):
        if not 0 < ratio < 1:
            raise ValueError("ratio must lie in (0, 1).")
        if surface_only and volume_only:
            raise ValueError(
                "surface_only and volume_only are mutually exclusive.")
        super().__init__(m1, m2, ratio)
        self.ratio = float(ratio)
        self.surface_only = bool(surface_only)
        self.volume_only = bool(volume_only)


class Add(_Mix):
    """Summed response of two materials (add.pyx:36), by the one-sample
    estimator: each child with probability 1/2, its contribution doubled."""

    ADD_WEIGHT = 2.0

    def __init__(self, m1, m2, surface_only=False, volume_only=False):
        if surface_only and volume_only:
            raise ValueError(
                "surface_only and volume_only are mutually exclusive.")
        super().__init__(m1, m2, 0.5)
        self.surface_only = bool(surface_only)
        self.volume_only = bool(volume_only)


class VolumeTransform(_Delegating):
    """Offset the wrapped material's volume-integration frame
    (transform.pyx:36): its emission function is evaluated at
    ``transform.inverse() @ p_local``."""

    def __init__(self, material, transform=None):
        super().__init__(material)
        from ...core.math.affinematrix import AffineMatrix3D

        self.transform = (transform if transform is not None
                          else AffineMatrix3D())

    def volume_frame_matrix(self):
        """The extra world -> frame matrix of the volume evaluation."""
        return self.transform.inverse().to_array(np.float64)
