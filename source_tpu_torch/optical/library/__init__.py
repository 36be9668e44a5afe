"""Data library (reference raysect/optical/library)."""

from ..colour import d65_white
from .glass import schott, schott_catalog

__all__ = ["d65_white", "schott", "schott_catalog"]
