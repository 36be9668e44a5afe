"""Schott glass catalog.

Counterpart of raysect/optical/library/glass/schott.py:51-94.
``schott(name)`` returns a Dielectric built from the glass's Sellmeier
dispersion coefficients and measured internal transmission curve.

The catalog is the full published Schott 2000 optical-glass datasheet set
(106 glasses; manufacturer datasheet constants), bundled in
data/schott_2000.json. Transmission points are internal transmittance for
a 25 mm sample; the loader converts to per-metre with tau_m = tau_25mm**40
(schott.py:80 semantics).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..material.dielectric import Dielectric, Sellmeier
from ..spectrum import InterpolatedSF

__all__ = ["schott", "schott_catalog", "schott_data"]

_DATA_PATH = Path(__file__).resolve().parent / "data" / "schott_2000.json"
_CATALOG = None


def _catalog():
    global _CATALOG
    if _CATALOG is None:
        with open(_DATA_PATH) as f:
            _CATALOG = json.load(f)
    return _CATALOG


def schott_catalog():
    """Available glass names (reference Schott.list, schott.py:97)."""
    return sorted(_catalog().keys())


def schott_data(name):
    """Raw catalog row: (sellmeier 6-tuple, tau25 wavelengths nm, tau25)."""
    d = _catalog()[name]
    return tuple(d["sellmeier"]), d["tau25_wavelengths"], d["tau25"]


def schott(name):
    """Build a Dielectric for the named Schott glass (schott.py:51-94).

    :param str name: Glass name, e.g. "N-BK7".
    """
    cat = _catalog()
    key = name if name in cat else name.upper()
    if key not in cat:
        raise ValueError(
            "This glass could not be found in the available Schott catalog: "
            f"{name!r}."
        )
    d = cat[key]
    b1, b2, b3, c1, c2, c3 = d["sellmeier"]
    w = np.asarray(d["tau25_wavelengths"], dtype=np.float64)
    # 25 mm internal transmittance -> per metre (schott.py:80: tau**40)
    tau_m = np.asarray(d["tau25"], dtype=np.float64) ** 40
    # interpolation wants ascending wavelengths (catalog is descending)
    order = np.argsort(w)
    transmission = InterpolatedSF(w[order], tau_m[order])
    return Dielectric(Sellmeier(b1, b2, b3, c1, c2, c3), transmission)
