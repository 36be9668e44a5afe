"""Data library (reference raysect/optical/library)."""

from .glass import schott, schott_catalog
from .metal import *  # noqa: F401,F403
from .metal import __all__ as _metal_all
from .spectra import (
    BlackBody, purple, blue, light_blue, cyan, green, yellow, orange,
    red_orange, red, maroon,
)
from ..colour import d65_white

__all__ = ["schott", "schott_catalog", "BlackBody", "d65_white",
           "purple", "blue", "light_blue", "cyan", "green", "yellow",
           "orange", "red_orange", "red", "maroon"] + list(_metal_all)
