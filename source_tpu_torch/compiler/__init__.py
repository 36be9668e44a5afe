from .scene import CompiledScene, SpectralConfig, compile_scene

__all__ = ["CompiledScene", "SpectralConfig", "compile_scene"]
