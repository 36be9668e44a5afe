"""Observers and pipelines (reference optical/observer)."""

from .base import (
    SpectralSlice, FrameSampler1D, FrameSampler2D, Pipeline,
    Pipeline0D, Pipeline1D, Pipeline2D, PixelProcessor,
    Observer0D, Observer1D, Observer2D,
)
from .imaging import (
    PinholeCamera, OrthographicCamera, CCDArray, VectorCamera,
    OpenCVCamera, TargetedCCDArray,
)
from .nonimaging import (
    Pixel, SightLine, FibreOptic, TargetedPixel, MeshPixel, MeshCamera,
)
from .pipelines import (
    RGBPipeline2D, BayerPipeline2D,
    PowerPipeline0D, PowerPipeline1D, PowerPipeline2D,
    RadiancePipeline0D, RadiancePipeline1D, RadiancePipeline2D,
    SpectralPowerPipeline0D, SpectralPowerPipeline1D, SpectralPowerPipeline2D,
    SpectralRadiancePipeline0D, SpectralRadiancePipeline1D,
    SpectralRadiancePipeline2D,
)
from .samplers import (
    FullFrameSampler1D, FullFrameSampler2D,
    MonoAdaptiveSampler1D, MonoAdaptiveSampler2D, MaskedMonoAdaptiveSampler2D,
    RGBAdaptiveSampler2D, MaskedRGBAdaptiveSampler2D,
    SpectralAdaptiveSampler1D, SpectralAdaptiveSampler2D,
)
from . import cameras

__all__ = [
    "SpectralSlice", "FrameSampler1D", "FrameSampler2D", "Pipeline",
    "Pipeline0D", "Pipeline1D", "Pipeline2D", "PixelProcessor",
    "Observer0D", "Observer1D", "Observer2D",
    "PinholeCamera", "OrthographicCamera", "CCDArray", "VectorCamera",
    "OpenCVCamera", "TargetedCCDArray",
    "Pixel", "SightLine", "FibreOptic", "TargetedPixel",
    "MeshPixel", "MeshCamera",
    "RGBPipeline2D", "BayerPipeline2D",
    "PowerPipeline0D", "PowerPipeline1D", "PowerPipeline2D",
    "RadiancePipeline0D", "RadiancePipeline1D", "RadiancePipeline2D",
    "SpectralPowerPipeline0D", "SpectralPowerPipeline1D",
    "SpectralPowerPipeline2D", "SpectralRadiancePipeline0D",
    "SpectralRadiancePipeline1D", "SpectralRadiancePipeline2D",
    "FullFrameSampler1D", "FullFrameSampler2D",
    "MonoAdaptiveSampler1D", "MonoAdaptiveSampler2D",
    "MaskedMonoAdaptiveSampler2D", "RGBAdaptiveSampler2D",
    "MaskedRGBAdaptiveSampler2D", "SpectralAdaptiveSampler1D",
    "SpectralAdaptiveSampler2D", "cameras",
]
