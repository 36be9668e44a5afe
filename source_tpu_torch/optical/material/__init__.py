from .base import (
    Material, NullSurface, NullVolume, NullMaterial, AbsorbingSurface,
    ContinuousBSDF, DiscreteBSDF,
)
from .lambert import Lambert
from .conductor import Conductor, RoughConductor
from .dielectric import Sellmeier, Dielectric
from .emitter import (
    UniformSurfaceEmitter, UnitySurfaceEmitter, AnisotropicSurfaceEmitter,
    Checkerboard, HomogeneousVolumeEmitter, UniformVolumeEmitter,
    UnityVolumeEmitter, InhomogeneousVolumeEmitter, VolumeIntegrator,
    NumericalIntegrator,
)
from .debug import Light, PerfectReflectingSurface

__all__ = [
    "Material", "NullSurface", "NullVolume", "NullMaterial",
    "AbsorbingSurface", "ContinuousBSDF", "DiscreteBSDF",
    "Lambert", "Conductor", "RoughConductor",
    "Sellmeier", "Dielectric", "UniformSurfaceEmitter",
    "UnitySurfaceEmitter", "AnisotropicSurfaceEmitter", "Checkerboard",
    "HomogeneousVolumeEmitter", "UniformVolumeEmitter", "UnityVolumeEmitter",
    "InhomogeneousVolumeEmitter", "VolumeIntegrator", "NumericalIntegrator",
    "Light", "PerfectReflectingSurface",
]
