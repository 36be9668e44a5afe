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

    def _query_world(self):
        """Single-primitive World backing hit/contains/next_intersection.

        An instance of this primitive (shared geometry) is parented to a
        private World at this primitive's root transform, and that world's
        compiled scene answers the query. Cached on the root transform;
        geometry mutations clear it via notify_geometry_change."""
        import numpy as np

        key = np.asarray(self.to_root().to_array(np.float64)).tobytes()
        cached = getattr(self, "_pq_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from ...optical.material.base import AbsorbingSurface

        world = World()
        self.instance(parent=world, transform=self.to_root(),
                      material=AbsorbingSurface())
        self._pq_cache = (key, world)
        return world

    def hit(self, ray, device="cuda"):
        """Closest intersection of ``ray`` with this primitive alone, or
        None (primitive.pyx:115-140), answered on ``device`` as
        ``World.hit`` answers. Enables the ``next_intersection`` cursor,
        which keeps the device."""
        intersection = self._query_world().hit(ray, device=device)
        self._next_cursor = None
        if intersection is None:
            return None
        intersection.primitive = self
        self._next_cursor = (ray, intersection.ray_distance, device)
        return intersection

    def next_intersection(self):
        """The next intersection along the ray supplied to the last
        ``hit`` call, or None when the ray has fully traversed this
        primitive (primitive.pyx:142-168). Successive calls enumerate
        successive surface crossings (used by CSG-style algorithms)."""
        cursor = getattr(self, "_next_cursor", None)
        if cursor is None:
            raise RuntimeError(
                "next_intersection() may only be called after a successful "
                "hit() on this primitive."
            )
        ray, t_prev, device = cursor
        # relaunch a copy of the ray just past the previous crossing
        import numpy as np

        from ..math.vector import Point3D, Vector3D

        o = np.asarray([ray.origin.x, ray.origin.y, ray.origin.z], np.float64)
        d = np.asarray(
            [ray.direction.x, ray.direction.y, ray.direction.z], np.float64
        )
        eps = 1e-4 * max(1.0, abs(t_prev))
        o2 = o + (t_prev + eps) * d
        relaunch = ray.copy(origin=Point3D(*o2), direction=Vector3D(*d))
        intersection = self._query_world().hit(relaunch, device=device)
        if intersection is None:
            self._next_cursor = None
            return None
        intersection.primitive = self
        t_total = t_prev + eps + intersection.ray_distance
        intersection.ray = ray
        intersection.ray_distance = t_total
        self._next_cursor = (ray, t_total, device)
        return intersection

    def contains(self, point, device="cuda"):
        """True when ``point`` lies inside this primitive
        (primitive.pyx:170-180)."""
        return len(self._query_world().contains(point, device=device)) > 0


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
        # compiled scene of the hit/contains queries, one per device
        self._query_scenes = {}

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
        self._query_scenes = {}

    # --- interactive scene queries (core/scenegraph/world.pyx:125-163) -------------

    def _build_query_scene(self, device="cuda"):
        """The compiled scene of the hit/contains queries on ``device``,
        compiled at first use and kept until a GEOMETRY or MATERIAL signal
        (the reference's lazy accelerator build, world.pyx:170-194). One
        spectral bin: geometry queries don't touch the spectral tables. The
        default device is the card; without one it raises."""
        from ...compiler.scene import SpectralConfig, compile_scene, resolve_device

        device = resolve_device(device)
        scene = self._query_scenes.get(device)
        if scene is None:
            scene = compile_scene(self, SpectralConfig(375.0, 740.0, 1),
                                  device=device)
            self._query_scenes[device] = scene
        return scene

    def build_accelerator(self, force=False, device="cuda"):
        """Reference-compatible alias for the lazy scene compile
        (world.pyx:170)."""
        if force:
            self._query_scenes = {}
        self._build_query_scene(device)

    def hit(self, ray, device="cuda"):
        """Find the closest intersection of ``ray`` with the scene, or None
        (world.pyx:125-147). Returns a core ``Intersection`` (a
        ``MeshIntersection`` for a mesh) whose hit/inside/outside points and
        normal are in the hit primitive's local space, matching the
        reference contract. ``intersect_scene`` answers on ``device`` (the
        analytic-BVH kernel for analytic and CSG entities and the mesh
        kernel for meshes, on the card); the record comes back to the host
        in one transfer."""
        import numpy as np
        import torch

        from ..intersection import Intersection
        from ..math.vector import Normal3D, Point3D
        from ...tracer.intersect import intersect_scene

        scene = self._build_query_scene(device)
        o = np.asarray(
            [[ray.origin.x, ray.origin.y, ray.origin.z]], dtype=np.float32
        )
        d = np.asarray(
            [[ray.direction.x, ray.direction.y, ray.direction.z]],
            dtype=np.float32,
        )
        # normalised on the host, in float32 as the reference does
        n = float(np.linalg.norm(d[0]))
        if n == 0.0:
            raise ValueError("Ray direction cannot be a zero-length vector.")
        rec = intersect_scene(scene, torch.from_numpy(o).to(scene.device),
                              torch.from_numpy(d / n).to(scene.device),
                              need_grad=False)
        # every field of the one-ray record in one float64 row (exact for
        # the f32, i32 and bool fields), pulled once
        row = torch.cat([
            x.reshape(1, -1).to(torch.float64) for x in (
                rec.hit, rec.t, rec.entity, rec.point, rec.inside_point,
                rec.outside_point, rec.normal, rec.exiting, rec.tri,
                rec.bary_u, rec.bary_v)], dim=1)[0].cpu().numpy()
        if not row[0]:
            return None
        t = float(row[1]) / n
        if t > ray.max_distance:
            return None
        prim = self._primitives[int(row[2])]
        w2p = prim.to_local()
        p2w = prim.to_root()
        hit_point = Point3D(*row[3:6]).transform(w2p)
        inside_point = Point3D(*row[6:9]).transform(w2p)
        outside_point = Point3D(*row[9:12]).transform(w2p)
        # world->local normal: inverse-transpose uses the local->world matrix.
        # Stays the OUTWARD surface normal regardless of `exiting`
        # (sphere.pyx:183-197 convention).
        local_normal = Normal3D(*row[12:15]).transform(p2w).normalise()
        exiting = bool(row[15])
        if getattr(prim, "is_mesh", False):
            from ...primitive.mesh.mesh import MeshIntersection

            u = float(row[17])
            v = float(row[18])
            return MeshIntersection(
                ray, t, prim, hit_point, inside_point, outside_point,
                local_normal, exiting, w2p, p2w,
                triangle=int(row[16]), u=u, v=v, w=1.0 - u - v,
            )
        return Intersection(
            ray, t, prim, hit_point, inside_point, outside_point,
            local_normal, exiting, w2p, p2w,
        )

    def contains(self, point, device="cuda"):
        """List of primitives containing ``point`` (world.pyx:149-163),
        answered by ``entity_contains`` on ``device`` (a closed mesh by a +z
        probe through the mesh kernel on the card)."""
        import torch

        from ...tracer.intersect import entity_contains

        scene = self._build_query_scene(device)
        p = torch.tensor([[point.x, point.y, point.z]], dtype=torch.float32,
                         device=scene.device)
        inside = entity_contains(scene, p)[0].cpu().tolist()
        return [
            self._primitives[e] for e in range(len(self._primitives))
            if inside[e]
        ]

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
