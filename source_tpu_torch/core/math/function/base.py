"""Function framework: composable scalar fields with operator algebra.

Counterpart of source_tpu/core/math/function/base.py (the reference's
Function1D/2D/3D class forest, raysect/core/math/function/float/
function{1,2,3}d/base.pyx:39-855: Add/Sub/Mul/Div/Modulo/Pow/Abs/comparison
nodes, function-function and function-scalar variants; autowrap.pyx:38-90
coercion; Arg/Constant and the cmath wrappers; Blend1D/2D/3D mask
interpolation). Instead of one Cython class per (operator x arity x operand
kind), a Function here is a thin Python node whose ``__call__`` evaluates
batched tensors, so an expression tree is a chain of tensor programs,
differentiable by autograd end to end.

The three arities share one implementation: ``_make_function_classes(n)``
stamps out Function1D/2D/3D (and their Arg/Constant/Blend/math-wrapper
companions) with the right argument count.

Where a Function evaluates: called with tensors, on their device; called
with Python numbers or numpy arrays (float32, as the JAX package takes
them), on the Function's ``device``, which is the card unless it was made
with ``device="cpu"`` (an operator node takes its operands'). Without a
card it raises rather than carry on on the CPU. A ``PythonFunction*``
receives tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Function1D", "Function2D", "Function3D",
    "Arg1D", "Arg2D", "Arg3D",
    "Constant1D", "Constant2D", "Constant3D",
    "Blend1D", "Blend2D", "Blend3D",
    "PythonFunction1D", "PythonFunction2D", "PythonFunction3D",
    "autowrap_function1d", "autowrap_function2d", "autowrap_function3d",
    "Exp1D", "Exp2D", "Exp3D", "Sin1D", "Sin2D", "Sin3D",
    "Cos1D", "Cos2D", "Cos3D", "Tan1D", "Tan2D", "Tan3D",
    "Asin1D", "Asin2D", "Asin3D", "Acos1D", "Acos2D", "Acos3D",
    "Atan1D", "Atan2D", "Atan3D", "Atan4Q1D", "Atan4Q2D", "Atan4Q3D",
    "Erf1D", "Erf2D", "Erf3D", "Sqrt1D", "Sqrt2D", "Sqrt3D",
]


def resolve(device):
    """The torch.device a host-facing object evaluates on when it is handed
    no tensor: ``device``, else the card (raising where there is none)."""
    from ....compiler.scene import resolve_device

    return resolve_device("cuda" if device is None else device)


def as_tensors(args, device=None):
    """``args`` as tensors on one device: that of the first tensor among
    them, else ``resolve(device)``. Numbers and numpy float arrays become
    float32 tensors (integer and boolean arrays keep their dtype); tensors
    stay as they are."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    if dev is None:
        dev = resolve(device)
    out = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            a = torch.as_tensor(a, dtype=torch.float32 if a.dtype.kind == "f"
                                else None, device=dev)
        elif a.device != dev:
            a = a.to(dev)
        out.append(a)
    return tuple(out)


def _device_of(*fs):
    """The first explicit device among the operands of an operator node."""
    return next((f.device for f in fs if getattr(f, "device", None) is not None),
                None)


def _remainder(a, b):
    return torch.remainder(a, b)  # sign of the divisor, as jnp.mod


def _comparison(op):
    def cmp(a, b):
        return op(a, b).to(torch.float32)
    cmp.__name__ = op.__name__
    return cmp


_EQ, _NE = _comparison(torch.eq), _comparison(torch.ne)
_LT, _LE = _comparison(torch.lt), _comparison(torch.le)
_GT, _GE = _comparison(torch.gt), _comparison(torch.ge)


def _make_function_classes(n):
    """Create the Function/Arg/Constant/Blend/autowrap family of arity n."""

    class Function:
        """Scalar field of arity %d with full operator algebra.""" % n

        _arity = n
        device = None  # where numbers and numpy arrays evaluate (None: card)

        def __call__(self, *args):
            raise NotImplementedError

        def _args(self, args):
            return as_tensors(args, self.device)

        # --- algebra (base.pyx operator nodes) ----------------------------------
        def __add__(self, other):
            return _binary(self, other, torch.add)

        def __radd__(self, other):
            return _binary(other, self, torch.add)

        def __sub__(self, other):
            return _binary(self, other, torch.sub)

        def __rsub__(self, other):
            return _binary(other, self, torch.sub)

        def __mul__(self, other):
            return _binary(self, other, torch.mul)

        def __rmul__(self, other):
            return _binary(other, self, torch.mul)

        def __truediv__(self, other):
            return _binary(self, other, torch.true_divide)

        def __rtruediv__(self, other):
            return _binary(other, self, torch.true_divide)

        def __mod__(self, other):
            return _binary(self, other, _remainder)

        def __rmod__(self, other):
            return _binary(other, self, _remainder)

        def __pow__(self, other):
            return _binary(self, other, torch.pow)

        def __rpow__(self, other):
            return _binary(other, self, torch.pow)

        def __neg__(self):
            return _unary(self, torch.neg)

        def __pos__(self):
            return self

        def __abs__(self):
            return _unary(self, torch.abs)

        # comparisons return 0/1-valued functions (base.pyx richcmp nodes)
        def __eq__(self, other):
            return _binary(self, other, _EQ)

        def __ne__(self, other):
            return _binary(self, other, _NE)

        def __lt__(self, other):
            return _binary(self, other, _LT)

        def __le__(self, other):
            return _binary(self, other, _LE)

        def __gt__(self, other):
            return _binary(self, other, _GT)

        def __ge__(self, other):
            return _binary(self, other, _GE)

        __hash__ = object.__hash__

    class _Lambda(Function):
        """Internal node evaluating a tensor closure."""

        def __init__(self, fn, repr_name="lambda", device=None):
            self._fn = fn
            self._repr = repr_name
            self.device = device

        def __call__(self, *args):
            return self._fn(*self._args(args))

        def __repr__(self):
            return f"<{Function.__name__}:{self._repr}>"

    class Constant(Function):
        """Constant field (Constant1D/2D/3D)."""

        def __init__(self, value, device=None):
            self.value = float(value)
            self.device = device

        def __call__(self, *args):
            if args:
                x = self._args(args)[0]
                return torch.full(x.shape, self.value, dtype=torch.float32,
                                  device=x.device)
            return torch.tensor(self.value, dtype=torch.float32,
                                device=resolve(self.device))

    class PythonFunction(Function):
        """Wrap an arbitrary callable of tensors (autowrap.pyx
        PythonFunctionXD)."""

        def __init__(self, function, device=None):
            self.function = function
            self.device = device

        def __call__(self, *args):
            return self.function(*self._args(args))

    def autowrap(obj):
        """Coerce Function | callable | number to a Function
        (autowrap.pyx:38-90)."""
        if isinstance(obj, Function):
            return obj
        if callable(obj):
            return PythonFunction(obj)
        return Constant(obj)

    def _unary(f, op):
        f = autowrap(f)
        return _Lambda(lambda *a: op(f(*a)), getattr(op, "__name__", "op"),
                       _device_of(f))

    def _binary(f, g, op):
        f = autowrap(f)
        g = autowrap(g)
        return _Lambda(lambda *a: op(f(*a), g(*a)), getattr(op, "__name__", "op"),
                       _device_of(f, g))

    class Blend(Function):
        """f1 + (f2 - f1) * clamp(mask, 0, 1) (BlendXD semantics)."""

        def __init__(self, f1, f2, mask, device=None):
            self._f1 = autowrap(f1)
            self._f2 = autowrap(f2)
            self._mask = autowrap(mask)
            self.device = device if device is not None else _device_of(
                self._f1, self._f2, self._mask)

        def __call__(self, *args):
            args = self._args(args)
            a = self._f1(*args)
            b = self._f2(*args)
            m = torch.clamp(self._mask(*args), 0.0, 1.0)
            return a + (b - a) * m

    # Arg functions: ArgXD('x'|'y'|'z') selects one coordinate
    _AXES = "xyz"[:n]

    class Arg(Function):
        """Coordinate selector (Arg1D/2D/3D)."""

        def __init__(self, axis="x", device=None):
            if axis not in _AXES:
                raise ValueError(f"axis must be one of {_AXES!r}")
            self.axis = axis
            self._idx = _AXES.index(axis)
            self.device = device

        def __call__(self, *args):
            return self._args(args)[self._idx]

    return Function, _Lambda, Constant, PythonFunction, autowrap, Blend, Arg


(Function1D, _Lambda1D, Constant1D, PythonFunction1D, autowrap_function1d,
 Blend1D, Arg1D) = _make_function_classes(1)
(Function2D, _Lambda2D, Constant2D, PythonFunction2D, autowrap_function2d,
 Blend2D, Arg2D) = _make_function_classes(2)
(Function3D, _Lambda3D, Constant3D, PythonFunction3D, autowrap_function3d,
 Blend3D, Arg3D) = _make_function_classes(3)

Function1D.__name__ = "Function1D"
Function2D.__name__ = "Function2D"
Function3D.__name__ = "Function3D"


def _math_wrapper(op, base, autowrap):
    class _Wrapper(base):
        def __init__(self, f, device=None):
            self._f = autowrap(f)
            self.device = device if device is not None else _device_of(self._f)

        def __call__(self, *args):
            return op(self._f(*self._args(args)))

    return _Wrapper


def _atan2_wrapper(base, autowrap):
    class _Atan4Q(base):
        """Four-quadrant arctangent of two functions (Atan4QXD)."""

        def __init__(self, f_num, f_den, device=None):
            self._fn = autowrap(f_num)
            self._fd = autowrap(f_den)
            self.device = device if device is not None else _device_of(
                self._fn, self._fd)

        def __call__(self, *args):
            args = self._args(args)
            return torch.atan2(self._fn(*args), self._fd(*args))

    return _Atan4Q


_MATH_OPS = {
    "Exp": torch.exp, "Sin": torch.sin, "Cos": torch.cos, "Tan": torch.tan,
    "Asin": torch.arcsin, "Acos": torch.arccos, "Atan": torch.arctan,
    "Erf": torch.special.erf, "Sqrt": torch.sqrt,
}

_ARITIES = {"1D": (Function1D, autowrap_function1d),
            "2D": (Function2D, autowrap_function2d),
            "3D": (Function3D, autowrap_function3d)}

for _name, _op in _MATH_OPS.items():
    for _dim, (_base, _aw) in _ARITIES.items():
        _cls = _math_wrapper(_op, _base, _aw)
        _cls.__name__ = f"{_name}{_dim}"
        globals()[f"{_name}{_dim}"] = _cls

for _dim, (_base, _aw) in _ARITIES.items():
    _cls = _atan2_wrapper(_base, _aw)
    _cls.__name__ = f"Atan4Q{_dim}"
    globals()[f"Atan4Q{_dim}"] = _cls
