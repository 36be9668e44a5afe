"""Vector3D-valued function framework.

Counterpart of source_tpu/core/math/function/vector3d.py (the reference's
raysect/core/math/function/vector3d/: FloatToVector3DFunction1D/2D/3D,
constants, blend): scalar-argument fields returning [..., 3] tensors instead
of Vector3D objects. Composable with the float framework: construct from
three scalar Functions or wrap a callable. They evaluate where the float
Functions do (base.py): on their arguments' device, else on the field's
``device``, the card unless it was made with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (
    as_tensors, autowrap_function1d, autowrap_function2d, autowrap_function3d,
)

__all__ = [
    "Vector3DFunction1D", "Vector3DFunction2D", "Vector3DFunction3D",
    "ConstantVector3D1D", "ConstantVector3D2D", "ConstantVector3D3D",
    "BlendVector3D1D", "BlendVector3D2D", "BlendVector3D3D",
    "FloatToVector3DFunction1D", "FloatToVector3DFunction2D",
    "FloatToVector3DFunction3D",
]


def _make(n, autowrap):
    class Vector3DFunction:
        """[..., 3]-valued field of arity %d.""" % n

        _arity = n
        device = None  # where numbers and numpy arrays evaluate (None: card)

        def __call__(self, *args):
            raise NotImplementedError

        def _args(self, args):
            return as_tensors(args, self.device)

        def __add__(self, other):
            o = _coerce(other)
            return _Lambda(lambda *a: self(*a) + o(*a), self.device)

        def __sub__(self, other):
            o = _coerce(other)
            return _Lambda(lambda *a: self(*a) - o(*a), self.device)

        def __neg__(self):
            return _Lambda(lambda *a: -self(*a), self.device)

        def __mul__(self, scalar):
            s = autowrap(scalar)
            return _Lambda(lambda *a: self(*a) * s(*a)[..., None], self.device)

        __rmul__ = __mul__

        def __truediv__(self, scalar):
            s = autowrap(scalar)
            return _Lambda(lambda *a: self(*a) / s(*a)[..., None], self.device)

        def dot(self, other):
            """Scalar Function: dot product with another vector function."""
            from .base import PythonFunction1D, PythonFunction2D, PythonFunction3D

            o = _coerce(other)
            cls = {1: PythonFunction1D, 2: PythonFunction2D, 3: PythonFunction3D}[n]
            return cls(lambda *a: torch.sum(self(*a) * o(*a), dim=-1),
                       device=self.device)

        def cross(self, other):
            o = _coerce(other)
            return _Lambda(lambda *a: torch.linalg.cross(self(*a), o(*a), dim=-1),
                           self.device)

    class _Lambda(Vector3DFunction):
        def __init__(self, fn, device=None):
            self._fn = fn
            self.device = device

        def __call__(self, *args):
            return self._fn(*self._args(args))

    class FloatToVector3D(Vector3DFunction):
        """A vector field from three scalar Functions
        (vector3d FloatToVector3DFunctionXD)."""

        def __init__(self, x_function, y_function, z_function, device=None):
            self._fx = autowrap(x_function)
            self._fy = autowrap(y_function)
            self._fz = autowrap(z_function)
            self.device = device

        def __call__(self, *args):
            args = self._args(args)
            return torch.stack(
                [self._fx(*args), self._fy(*args), self._fz(*args)], dim=-1)

    class Constant(Vector3DFunction):
        """A constant vector, one float32 copy per device."""

        def __init__(self, vector, device=None):
            if hasattr(vector, "x"):  # Vector3D/Point3D-like
                vector = (vector.x, vector.y, vector.z)
            value = torch.as_tensor(np.asarray(list(vector), np.float32))
            if value.shape != (3,):
                raise ValueError("Constant vector must have 3 components.")
            self.value = value
            self.device = device
            self._copies = {value.device: value}

        def _on(self, device):
            v = self._copies.get(device)
            if v is None:
                v = self._copies[device] = self.value.to(device)
            return v

        def __call__(self, *args):
            if args:
                x = self._args(args)[0]
                return self._on(x.device).expand(x.shape + (3,))
            from .base import resolve

            return self._on(resolve(self.device))

    class Blend(Vector3DFunction):
        """v1 + (v2 - v1) * clamp(mask, 0, 1)."""

        def __init__(self, f1, f2, mask, device=None):
            self._f1 = _coerce(f1)
            self._f2 = _coerce(f2)
            self._mask = autowrap(mask)
            self.device = device

        def __call__(self, *args):
            args = self._args(args)
            a = self._f1(*args)
            b = self._f2(*args)
            m = torch.clamp(self._mask(*args), 0.0, 1.0)[..., None]
            return a + (b - a) * m

    def _coerce(obj):
        if isinstance(obj, Vector3DFunction):
            return obj
        if callable(obj):
            return _Lambda(obj)
        return Constant(obj)

    return Vector3DFunction, FloatToVector3D, Constant, Blend


(Vector3DFunction1D, FloatToVector3DFunction1D, ConstantVector3D1D,
 BlendVector3D1D) = _make(1, autowrap_function1d)
(Vector3DFunction2D, FloatToVector3DFunction2D, ConstantVector3D2D,
 BlendVector3D2D) = _make(2, autowrap_function2d)
(Vector3DFunction3D, FloatToVector3DFunction3D, ConstantVector3D3D,
 BlendVector3D3D) = _make(3, autowrap_function3d)
