"""EncapsulatedPrimitive: re-export a hidden primitive tree as one node.

Counterpart of raysect/primitive/utility.pyx:36. The wrapped primitive is
held un-rooted (like CSG children) and its compile hooks are delegated with
the wrapper's transform composed in; the wrapper's material overrides the
inner one.
"""

from __future__ import annotations

from ..core.scenegraph.node import Primitive

__all__ = ["EncapsulatedPrimitive"]


class EncapsulatedPrimitive(Primitive):
    """Delegating wrapper primitive (utility.pyx:36)."""

    def __init__(self, primitive, parent=None, transform=None, material=None,
                 name=None):
        if primitive.parent is not None:
            raise ValueError(
                "The encapsulated primitive cannot already be attached to a scenegraph."
            )
        self._primitive = primitive
        super().__init__(parent, transform, material, name)

    @property
    def primitive(self):
        return self._primitive

    def csg_leaves(self, world_transform):
        return self._primitive.csg_leaves(
            world_transform * self._primitive.transform
        )

    def n_csg_leaves(self):
        return self._primitive.n_csg_leaves()

    def csg_program(self, leaf_base):
        return self._primitive.csg_program(leaf_base)

    def bounding_box_world(self, world_transform):
        return self._primitive.bounding_box_world(
            world_transform * self._primitive.transform
        )

    def bounding_box(self):
        return self.bounding_box_world(self.to_root())

    def instance(self, parent=None, transform=None, material=None, name=None):
        obj = type(self).__new__(type(self))
        Primitive.__init__(obj, parent, transform, material or self.material, name)
        obj._primitive = self._primitive
        return obj
