"""Metal materials library.

Counterpart of raysect/optical/library/metal/{metal,roughmetal}.py
(18 measured metals, metal.py:57-162). Complex refractive indices n + ik
are the full measured tables from the public-domain (CC0) optical-constant
compilations distributed by refractiveindex.info (Rakic 1998,
Johnson & Christy 1972, ...), bundled in data/metals_nk.json.

``Cobolt`` (reference spelling, metal.py:69) is kept as an alias of
``Cobalt``.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..material.conductor import Conductor, RoughConductor
from ..spectrum import InterpolatedSF

__all__ = [
    "Aluminium", "Beryllium", "Cobalt", "Cobolt", "Copper", "Gold", "Iron",
    "Lithium", "Magnesium", "Manganese", "Mercury", "Nickel", "Palladium",
    "Platinum", "Silicon", "Silver", "Sodium", "Titanium", "Tungsten",
    "RoughAluminium", "RoughBeryllium", "RoughCobalt", "RoughCobolt",
    "RoughCopper", "RoughGold", "RoughIron", "RoughLithium",
    "RoughMagnesium", "RoughManganese", "RoughMercury", "RoughNickel",
    "RoughPalladium", "RoughPlatinum", "RoughSilicon", "RoughSilver",
    "RoughSodium", "RoughTitanium", "RoughTungsten", "metal_nk",
]

_DATA_PATH = Path(__file__).resolve().parent / "data" / "metals_nk.json"
_NK_CACHE = None


def _nk_tables():
    global _NK_CACHE
    if _NK_CACHE is None:
        with open(_DATA_PATH) as f:
            _NK_CACHE = json.load(f)
    return _NK_CACHE


def metal_nk(name):
    """Raw measured (wavelength_nm, n, k) arrays for the named metal."""
    d = _nk_tables()[name]
    return d["wavelength"], d["index"], d["extinction"]


def _make_conductor(key, cls_name):
    class _Metal(Conductor):
        __doc__ = f"Measured n/k conductor: {cls_name} (metal.py:57-162)."

        def __init__(self):
            w, n, k = metal_nk(key)
            super().__init__(InterpolatedSF(w, n), InterpolatedSF(w, k))

    _Metal.__name__ = cls_name
    _Metal.__qualname__ = cls_name
    return _Metal


def _make_rough(key, cls_name):
    class _RoughMetal(RoughConductor):
        __doc__ = f"Rough measured n/k conductor: {cls_name} (roughmetal.py)."

        def __init__(self, roughness):
            w, n, k = metal_nk(key)
            super().__init__(InterpolatedSF(w, n), InterpolatedSF(w, k), roughness)

    _RoughMetal.__name__ = cls_name
    _RoughMetal.__qualname__ = cls_name
    return _RoughMetal


# data-file key -> canonical class name (reference keeps the 'cobolt' typo)
_METALS = {
    "aluminium": "Aluminium", "beryllium": "Beryllium", "cobolt": "Cobalt",
    "copper": "Copper", "gold": "Gold", "iron": "Iron", "lithium": "Lithium",
    "magnesium": "Magnesium", "manganese": "Manganese", "mercury": "Mercury",
    "nickel": "Nickel", "palladium": "Palladium", "platinum": "Platinum",
    "silicon": "Silicon", "silver": "Silver", "sodium": "Sodium",
    "titanium": "Titanium", "tungsten": "Tungsten",
}

for _key, _name in _METALS.items():
    globals()[_name] = _make_conductor(_key, _name)
    globals()["Rough" + _name] = _make_rough(_key, "Rough" + _name)

# reference spelling aliases (metal.py:69 uses 'Cobolt')
Cobolt = globals()["Cobalt"]
RoughCobolt = globals()["RoughCobalt"]
