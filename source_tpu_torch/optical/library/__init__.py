"""Data library (reference raysect/optical/library)."""

from .glass import schott, schott_catalog

__all__ = ["schott", "schott_catalog"]
