"""Unit conversion helpers (raysect/core/math/units.pyx:35-135).

Length converters return metres; angle converters return radians. All are
plain multiplications, so they take scalars, arrays and tensors alike.
"""

from __future__ import annotations

import math

__all__ = [
    "kilometre", "metre", "centimetre", "millimetre", "micrometre",
    "nanometre", "mile", "yard", "foot", "inch", "mil",
    "degree", "radian",
    # reference-compatible short names (units.pyx:35-135)
    "km", "cm", "mm", "um", "nm",
]


def kilometre(v):
    return v * 1e3


def metre(v):
    return v * 1.0


def centimetre(v):
    return v * 1e-2


def millimetre(v):
    return v * 1e-3


def micrometre(v):
    return v * 1e-6


def nanometre(v):
    return v * 1e-9


def mile(v):
    return v * 1609.344


def yard(v):
    return v * 0.9144


def foot(v):
    return v * 0.3048


def inch(v):
    return v * 0.0254


def mil(v):
    """Thousandth of an inch."""
    return v * 2.54e-5


def degree(v):
    """Degrees to radians (extension; the reference's angle helper is
    ``radian`` below)."""
    return v * (math.pi / 180.0)


def radian(v):
    """Radians to degrees (matches units.pyx:135 — raysect's angular API
    takes degrees, so this converts *to* its convention)."""
    return v * (180.0 / math.pi)


# reference-compatible short names (units.pyx:35-135)
km = kilometre
cm = centimetre
mm = millimetre
um = micrometre
nm = nanometre
