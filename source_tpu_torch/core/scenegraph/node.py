"""Host-side scenegraph.

Re-design of raysect/core/scenegraph/{_nodebase,node,primitive,
observer,world,signal}.pyx. The scenegraph is a pure-Python *scene
description* — it never appears on the device. Instead, ``World`` hands the tree
to the scene compiler (source_tpu_torch/compiler/scene.py) which flattens it into
SoA device arrays; the lazy ``GEOMETRY``/``MATERIAL`` change-signal machinery
(signal.pyx:49-67, world.pyx:220-238) is kept and used to invalidate the
compiled scene instead of a kd-tree.
"""

from __future__ import annotations

from ..math.affinematrix import AffineMatrix3D

__all__ = [
    "ChangeSignal",
    "GEOMETRY",
    "MATERIAL",
    "NodeBase",
    "Node",
    "Primitive",
    "Observer",
    "World",
    "print_scenegraph",
]


class ChangeSignal:
    """Interned change signal (signal.pyx:49)."""

    _interned = {}

    def __new__(cls, name):
        if name in cls._interned:
            return cls._interned[name]
        obj = super().__new__(cls)
        obj.name = name
        cls._interned[name] = obj
        return obj

    def __repr__(self):
        return f"ChangeSignal({self.name!r})"


GEOMETRY = ChangeSignal("GEOMETRY")
MATERIAL = ChangeSignal("MATERIAL")


class NodeBase:
    """Scenegraph node base (reference _NodeBase, _nodebase.pyx:36).

    Maintains parent/children links and cached root transforms, propagating
    recomputation down the tree on attachment/transform changes.
    """

    def __init__(self, parent=None, transform=None, name=None):
        self._parent = None
        self._children = []
        self._transform = transform if transform is not None else AffineMatrix3D()
        self._root = self
        self._root_transform = AffineMatrix3D()
        self._root_transform_inverse = AffineMatrix3D()
        self.name = name
        if parent is not None:
            self.parent = parent

    # --- tree management -------------------------------------------------------

    @property
    def parent(self):
        return self._parent

    @parent.setter
    def parent(self, value):
        if value is self._parent:
            return
        if value is self:
            raise ValueError("A node cannot be parented to itself.")
        if value is not None:
            self._check_parent(value)
        # detach
        if self._parent is not None:
            self._parent._children.remove(self)
        old_root = self._root
        self._parent = value
        if value is not None:
            value._children.append(self)
        self._update()
        if old_root is not self._root and old_root is not self:
            old_root._change(self, GEOMETRY)

    def _check_parent(self, candidate):
        """Reject parenting cycles (_nodebase.pyx:68)."""
        node = candidate
        while node is not None:
            if node is self:
                raise ValueError("Attaching the node would create a cycle.")
            node = node._parent

    @property
    def children(self):
        return list(self._children)

    @property
    def root(self):
        return self._root

    @property
    def transform(self):
        return self._transform

    @transform.setter
    def transform(self, value):
        if not isinstance(value, AffineMatrix3D):
            raise TypeError("Transform must be an AffineMatrix3D.")
        self._transform = value
        self._update()

    def _update(self):
        """Recompute cached root transforms, register with the root, signal
        geometry change, recurse into children (_nodebase.pyx:83-134)."""
        if self._parent is None:
            self._root = self
            self._root_transform = AffineMatrix3D()
            self._root_transform_inverse = AffineMatrix3D()
        else:
            new_root = self._parent._root
            if self._root is not new_root:
                if self._root is not self:
                    self._root._deregister(self)
                self._root = new_root
                self._root._register(self)
            self._root_transform = self._parent._root_transform * self._transform
            self._root_transform_inverse = self._root_transform.inverse()
        self._root._change(self, GEOMETRY)
        for child in self._children:
            child._update()

    # --- root hooks (overridden by World) ---------------------------------------

    def _register(self, node):
        pass

    def _deregister(self, node):
        pass

    def _change(self, node, signal):
        pass

    # --- coordinate conversions --------------------------------------------------

    def to_root(self):
        """Transform local -> root space."""
        return self._root_transform

    def to_local(self):
        """Transform root -> local space."""
        return self._root_transform_inverse

    def to(self, node):
        """Transform from this node's space to another node's space
        (node.pyx to())."""
        if self._root is not node._root:
            raise ValueError("The nodes are not in the same scenegraph.")
        return node.to_local() * self._root_transform


class Node(NodeBase):
    """User-facing scenegraph node (node.pyx:32)."""

    def __repr__(self):
        return f"<Node: {self.name!r}>"


class Primitive(NodeBase):
    """Scenegraph primitive base (core/scenegraph/primitive.pyx:35).

    Concrete geometry classes live in source_tpu_torch/primitive; they override the
    compile hooks consumed by the scene compiler rather than per-ray hit()
    methods — intersection happens in batched device kernels.
    """

    def __init__(self, parent=None, transform=None, material=None, name=None):
        self._material = material
        super().__init__(parent, transform, name)
        if material is not None and hasattr(material, "primitives"):
            material.primitives.append(self)

    @property
    def material(self):
        return self._material

    @material.setter
    def material(self, value):
        if self._material is not None and hasattr(self._material, "primitives"):
            try:
                self._material.primitives.remove(self)
            except ValueError:
                pass
        self._material = value
        if value is not None and hasattr(value, "primitives"):
            value.primitives.append(self)
        self.notify_material_change()

    def notify_geometry_change(self):
        """Signal the root that this primitive's geometry changed
        (primitive.pyx:201)."""
        self._pq_cache = None
        self._root._change(self, GEOMETRY)

    def notify_material_change(self):
        self._root._change(self, MATERIAL)

    def __repr__(self):
        return f"<{type(self).__name__}: {self.name!r}>"

    # --- compile hooks ------------------------------------------------------------

    def csg_leaves(self, world_transform):
        """Yield (type_id, local->world AffineMatrix3D, params tuple) for every
        analytic leaf of this primitive. ``world_transform`` is the
        primitive's local->root matrix."""
        raise NotImplementedError

    def csg_program(self, leaf_base):
        """Postfix boolean program over this primitive's leaves, as a list of
        (op, operand) pairs. Leaf pushes use global leaf index
        leaf_base + local index. Simple primitives: [(OP_LEAF, leaf_base)]."""
        raise NotImplementedError

    def bounding_box(self):
        """World-space axis-aligned bounding box -> (lower[3], upper[3])."""
        raise NotImplementedError

    def bounding_sphere(self):
        """World-space bounding sphere -> (centre Point3D, radius)."""
        import numpy as np

        lower, upper = self.bounding_box()
        lower = np.asarray(lower)
        upper = np.asarray(upper)
        centre = 0.5 * (lower + upper)
        radius = float(np.linalg.norm(upper - centre))
        from ..math.vector import Point3D

        return Point3D(*centre), radius

    # --- direct geometry queries (primitive.pyx:115-223) ---------------------------

    _QUERY_MSG = (
        "direct geometry queries need the streaming intersection path "
        "(tracer/intersect.py), which this package does not carry yet"
    )

    def hit(self, ray):
        """Closest intersection of ``ray`` with this primitive alone
        (primitive.pyx:115-140)."""
        raise NotImplementedError(self._QUERY_MSG)

    def next_intersection(self):
        """The next intersection along the ray of the last ``hit`` call
        (primitive.pyx:142-168)."""
        raise NotImplementedError(self._QUERY_MSG)

    def contains(self, point):
        """True when ``point`` lies inside this primitive
        (primitive.pyx:170-180)."""
        raise NotImplementedError(self._QUERY_MSG)


class Observer(NodeBase):
    """Marker node class for observers (core/scenegraph/observer.pyx:32)."""


class World(NodeBase):
    """Scenegraph root (core/scenegraph/world.pyx:40).

    Tracks primitives/observers and invalidates the compiled scene on
    GEOMETRY/MATERIAL signals — the analogue of the reference's lazy
    kd-tree rebuild (world.pyx:220-238).
    """

    def __init__(self, name=None):
        super().__init__(None, None, name)
        self._primitives = []
        self._observers = []
        self._scene_dirty = True
        self._material_dirty = True

    @property
    def primitives(self):
        return list(self._primitives)

    @property
    def observers(self):
        return list(self._observers)

    @NodeBase.parent.setter
    def parent(self, value):
        if value is not None:
            raise TypeError("A world node cannot be parented to another node.")

    def _register(self, node):
        if isinstance(node, Primitive) and node not in self._primitives:
            self._primitives.append(node)
        if isinstance(node, Observer) and node not in self._observers:
            self._observers.append(node)

    def _deregister(self, node):
        if isinstance(node, Primitive) and node in self._primitives:
            self._primitives.remove(node)
        if isinstance(node, Observer) and node in self._observers:
            self._observers.remove(node)
        # children of the departing subtree deregister themselves via _update

    def _change(self, node, signal):
        if signal is GEOMETRY:
            self._scene_dirty = True
            self._material_dirty = True
        elif signal is MATERIAL:
            self._material_dirty = True

    # --- interactive scene queries (core/scenegraph/world.pyx:125-163) -------------

    def hit(self, ray):
        """Closest intersection of ``ray`` with the scene (world.pyx:125-147)."""
        raise NotImplementedError(Primitive._QUERY_MSG)

    def contains(self, point):
        """List of primitives containing ``point`` (world.pyx:149-163)."""
        raise NotImplementedError(Primitive._QUERY_MSG)

    def __repr__(self):
        return f"<World: {self.name!r}>"


def print_scenegraph(node, indent=0):
    """Pretty-print a scenegraph subtree (scenegraph/utility.pyx:39).

    Iterative preorder with an explicit stack — deep bridge chains
    (procedurally generated scenegraphs) must not hit the interpreter
    recursion limit.
    """
    lines = []
    stack = [(node, indent)]
    while stack:
        n, ind = stack.pop()
        lines.append(" " * ind + repr(n))
        for child in reversed(n.children):
            stack.append((child, ind + 2))
    text = "\n".join(lines)
    if indent == 0:
        print(text)
    return text


class BridgeNode(Node):
    """Root node that forwards change signals into another scenegraph
    (core/scenegraph/utility.pyx:39): used to host private subtrees whose
    geometry changes must invalidate a main World's accelerator."""

    def __init__(self, destination):
        super().__init__()
        self.destination = destination

    def _change(self, node, signal):
        self.destination.root._change(self.destination, signal)
