"""Function framework: composable fields, interpolators, mesh interpolators
(the counterpart of source_tpu/core/math/function)."""

from .base import (
    Arg1D, Arg2D, Arg3D,
    Atan4Q1D, Atan4Q2D, Atan4Q3D,
    Blend1D, Blend2D, Blend3D,
    Constant1D, Constant2D, Constant3D,
    Function1D, Function2D, Function3D,
    PythonFunction1D, PythonFunction2D, PythonFunction3D,
    autowrap_function1d, autowrap_function2d, autowrap_function3d,
    Exp1D, Exp2D, Exp3D, Sin1D, Sin2D, Sin3D, Cos1D, Cos2D, Cos3D,
    Tan1D, Tan2D, Tan3D, Asin1D, Asin2D, Asin3D, Acos1D, Acos2D, Acos3D,
    Atan1D, Atan2D, Atan3D, Erf1D, Erf2D, Erf3D, Sqrt1D, Sqrt2D, Sqrt3D,
)
from .interpolate import Interpolator1DArray, Interpolator2DArray, Interpolator3DArray
from .mesh_interp import Discrete2DMesh, Discrete3DMesh, Interpolator2DMesh
from .samplers import sample1d, sample1d_points
from .vector3d import (
    BlendVector3D1D, BlendVector3D2D, BlendVector3D3D,
    ConstantVector3D1D, ConstantVector3D2D, ConstantVector3D3D,
    FloatToVector3DFunction1D, FloatToVector3DFunction2D,
    FloatToVector3DFunction3D,
    Vector3DFunction1D, Vector3DFunction2D, Vector3DFunction3D,
)

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
    "Interpolator1DArray", "Interpolator2DArray", "Interpolator3DArray",
    "Interpolator2DMesh", "Discrete2DMesh", "Discrete3DMesh",
    "sample1d", "sample1d_points",
    "Vector3DFunction1D", "Vector3DFunction2D", "Vector3DFunction3D",
    "ConstantVector3D1D", "ConstantVector3D2D", "ConstantVector3D3D",
    "BlendVector3D1D", "BlendVector3D2D", "BlendVector3D3D",
    "FloatToVector3DFunction1D", "FloatToVector3DFunction2D",
    "FloatToVector3DFunction3D",
]
