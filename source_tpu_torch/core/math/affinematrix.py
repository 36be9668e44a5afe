"""4x4 affine transform matrix, host-side.

Equivalent of raysect/core/math/{_mat4,affinematrix}.pyx. Backed by
nested python floats for fast host use; exposes ``.to_array()`` for device
upload. Device batched transforms live in :mod:`source_tpu_torch.core.math.batch`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AffineMatrix3D"]


class AffineMatrix3D:
    """A 4x4 affine transform (reference affinematrix.pyx:36)."""

    __slots__ = ("m",)

    def __init__(self, m=None):
        if m is None:
            self.m = [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ]
        else:
            arr = np.asarray(m, dtype=np.float64)
            if arr.shape != (4, 4):
                raise ValueError("AffineMatrix3D must be initialised with a 4x4 matrix.")
            self.m = [[float(v) for v in row] for row in arr]

    def __repr__(self):
        return "AffineMatrix3D(" + repr(self.m) + ")"

    def __getitem__(self, idx):
        i, j = idx
        return self.m[i][j]

    def __setitem__(self, idx, value):
        i, j = idx
        self.m[i][j] = float(value)

    def __eq__(self, other):
        if isinstance(other, AffineMatrix3D):
            return self.m == other.m
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, AffineMatrix3D):
            a = self.m
            b = other.m
            out = [[0.0] * 4 for _ in range(4)]
            for i in range(4):
                for j in range(4):
                    out[i][j] = (
                        a[i][0] * b[0][j]
                        + a[i][1] * b[1][j]
                        + a[i][2] * b[2][j]
                        + a[i][3] * b[3][j]
                    )
            r = AffineMatrix3D.__new__(AffineMatrix3D)
            r.m = out
            return r
        return NotImplemented

    def get_element(self, i, j):
        return self.m[i][j]

    def set_element(self, i, j, v):
        self.m[i][j] = float(v)

    def inverse(self):
        """Matrix inverse (affinematrix.pyx inverse())."""
        inv = np.linalg.inv(np.asarray(self.m, dtype=np.float64))
        r = AffineMatrix3D.__new__(AffineMatrix3D)
        r.m = [[float(v) for v in row] for row in inv]
        return r

    def is_identity(self, tolerance=1e-8):
        ident = np.eye(4)
        return bool(np.allclose(np.asarray(self.m), ident, atol=tolerance))

    def is_close(self, other, tolerance=1e-8):
        return bool(
            np.allclose(np.asarray(self.m), np.asarray(other.m), atol=tolerance)
        )

    def to_array(self, dtype=np.float32):
        return np.asarray(self.m, dtype=dtype)

    def copy(self):
        r = AffineMatrix3D.__new__(AffineMatrix3D)
        r.m = [row[:] for row in self.m]
        return r

    def __getstate__(self):
        return self.m

    def __setstate__(self, state):
        self.m = state

    def __reduce__(self):
        return (AffineMatrix3D, (self.m,))
