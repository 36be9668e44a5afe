"""Core layer: math substrate + scenegraph (reference raysect/core)."""

from .math import *  # noqa: F401,F403
from .math import __all__ as _math_all
from .scenegraph import (
    ChangeSignal, GEOMETRY, MATERIAL, Node, NodeBase, Observer, Primitive,
    World, print_scenegraph,
)

__all__ = list(_math_all) + [
    "ChangeSignal", "GEOMETRY", "MATERIAL", "Node", "NodeBase", "Observer",
    "Primitive", "World", "print_scenegraph",
]
