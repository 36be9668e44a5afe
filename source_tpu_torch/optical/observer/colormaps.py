"""Colormap helpers for pipeline display (pipeline/colormaps.py parity).

Provides a small self-contained viridis-like colormap plus matplotlib
pass-through when available, so mono/spectral pipelines can render
false-colour frames without a hard matplotlib dependency.
"""

from __future__ import annotations

import numpy as np

__all__ = ["apply_colormap", "SAMPLED_VIRIDIS"]

# coarse viridis control points (public-domain colormap data, decimated)
SAMPLED_VIRIDIS = np.asarray([
    [0.267, 0.005, 0.329],
    [0.283, 0.141, 0.458],
    [0.254, 0.265, 0.530],
    [0.207, 0.372, 0.553],
    [0.164, 0.471, 0.558],
    [0.128, 0.567, 0.551],
    [0.135, 0.659, 0.518],
    [0.267, 0.749, 0.441],
    [0.478, 0.821, 0.318],
    [0.741, 0.873, 0.150],
    [0.993, 0.906, 0.144],
])


def apply_colormap(values, cmap="viridis", vmin=None, vmax=None):
    """Map a 2D scalar array to an RGB image [.., 3] in [0, 1].

    Uses matplotlib's colormaps when importable, else the built-in
    sampled viridis.
    """
    v = np.asarray(values, np.float64)
    lo = v.min() if vmin is None else vmin
    hi = v.max() if vmax is None else vmax
    t = np.clip((v - lo) / max(hi - lo, 1e-300), 0.0, 1.0)
    try:
        import matplotlib.cm as cm

        return np.asarray(cm.get_cmap(cmap)(t))[..., :3]
    except Exception:
        idx = t * (len(SAMPLED_VIRIDIS) - 1)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, len(SAMPLED_VIRIDIS) - 1)
        frac = (idx - i0)[..., None]
        return SAMPLED_VIRIDIS[i0] * (1 - frac) + SAMPLED_VIRIDIS[i1] * frac
