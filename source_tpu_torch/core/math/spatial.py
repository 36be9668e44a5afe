"""Generic spatial kd-trees over item bounding boxes.

Counterpart of source_tpu/core/math/spatial.py, itself the counterpart of
the reference's subclassable spatial cores
(core/math/spatial/kdtree3d.pyx:103 ``KDTree3DCore`` and
kdtree2d.pyx:101 ``KDTree2DCore``): a host-side kd-tree built from
(id, AABB) items, answering point containment-candidate queries and
serialisable to disk. The reference uses these for mesh acceleration and
mesh interpolators; here the *device* hot paths use the threaded BVH
(accel/bvh.py, the mesh kernel) and uniform-grid candidate bins
(function/mesh_interp.py), so these trees serve the host-side/utility
role only — built with the same PBRT-style auto depth
⌈8 + 1.3·ln N⌉ (kdtree3d.pyx:126-145).

Pure numpy. Splits use the surface-area-weighted midpoint of the
largest axis with a min-items leaf cutoff — the reference's full SAH
sweep buys nothing for the candidate-bin queries these host trees serve.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Item2D", "Item3D", "KDTree2D", "KDTree3D"]


class Item3D:
    """An (id, bounding box) pair fed to KDTree3D (kdtree3d.pyx:60)."""

    def __init__(self, id, box):
        self.id = id
        self.box = box  # BoundingBox3D (or any object with .lower/.upper)


class Item2D:
    """An (id, bounding box) pair fed to KDTree2D (kdtree2d.pyx:57)."""

    def __init__(self, id, box):
        self.id = id
        self.box = box


class _KDTreeCore:
    """Shared N-dimensional kd-tree over item AABBs.

    Flat node arrays mirroring the reference's packed ``kdnode*`` layout
    (kdtree3d.pxd:38-44): internal nodes store (axis, split, upper-child
    index); leaves store a slice into a flat item-id list.
    """

    _ndim = 3

    def __init__(self, items, max_depth=0, min_items=1):
        n = len(items)
        ids = np.asarray([it.id for it in items], np.int32)
        lower = np.asarray(
            [self._lower(it.box) for it in items], np.float64
        ).reshape(n, self._ndim)
        upper = np.asarray(
            [self._upper(it.box) for it in items], np.float64
        ).reshape(n, self._ndim)
        if max_depth <= 0:
            # PBRT auto depth (kdtree3d.pyx:145)
            max_depth = int(math.ceil(8 + 1.3 * math.log(n))) if n else 1
        self.min_items = max(1, min_items)

        # flat arrays: axis=-1 marks a leaf; children as (lower=i+1, upper)
        self._axis, self._split, self._upper_child = [], [], []
        self._leaf_start, self._leaf_count = [], []
        self._leaf_items = []

        self._bounds_lower = lower
        self._bounds_upper = upper
        self._ids = ids
        self._build(np.arange(n), 0, max_depth)
        self._axis = np.asarray(self._axis, np.int8)
        self._split = np.asarray(self._split, np.float64)
        self._upper_child = np.asarray(self._upper_child, np.int32)
        self._leaf_start = np.asarray(self._leaf_start, np.int32)
        self._leaf_count = np.asarray(self._leaf_count, np.int32)
        self._leaf_items = np.asarray(self._leaf_items, np.int32)

    @staticmethod
    def _lower(box):  # pragma: no cover - subclasses override
        raise NotImplementedError

    @staticmethod
    def _upper(box):  # pragma: no cover - subclasses override
        raise NotImplementedError

    def _add_node(self):
        self._axis.append(-1)
        self._split.append(0.0)
        self._upper_child.append(-1)
        self._leaf_start.append(0)
        self._leaf_count.append(0)
        return len(self._axis) - 1

    def _build(self, sel, depth, max_depth):
        node = self._add_node()
        if len(sel) <= self.min_items or depth >= max_depth:
            self._make_leaf(node, sel)
            return node
        lo = self._bounds_lower[sel]
        up = self._bounds_upper[sel]
        extent = up.max(axis=0) - lo.min(axis=0)
        axis = int(np.argmax(extent))
        split = float((up[:, axis].max() + lo[:, axis].min()) * 0.5)
        below = sel[self._bounds_lower[sel, axis] < split]
        above = sel[self._bounds_upper[sel, axis] > split]
        # degenerate split (all items straddle): make a leaf
        if len(below) == len(sel) and len(above) == len(sel):
            self._make_leaf(node, sel)
            return node
        self._axis[node] = axis
        self._split[node] = split
        self._build(below, depth + 1, max_depth)  # lower child = node + 1
        self._upper_child[node] = self._build(above, depth + 1, max_depth)
        return node

    def _make_leaf(self, node, sel):
        # store item *indices*; ids resolve through self._ids at query time
        self._leaf_start[node] = len(self._leaf_items)
        self._leaf_count[node] = len(sel)
        self._leaf_items.extend(np.asarray(sel, np.int32).tolist())

    # --- queries ---------------------------------------------------------

    def items_containing(self, point):
        """Item ids whose AABB contains ``point`` (kdtree3d.pyx:736) —
        candidate list; the caller applies the exact containment test."""
        p = self._point_array(point)
        out = []
        stack = [0]
        while stack:
            node = stack.pop()
            axis = int(self._axis[node])
            if axis < 0:
                s = int(self._leaf_start[node])
                c = int(self._leaf_count[node])
                for k in self._leaf_items[s:s + c]:
                    k = int(k)
                    if np.all(self._bounds_lower[k] <= p) and np.all(
                        p <= self._bounds_upper[k]
                    ):
                        out.append(int(self._ids[k]))
                continue
            if p[axis] <= self._split[node]:
                stack.append(node + 1)
            if p[axis] >= self._split[node]:
                stack.append(int(self._upper_child[node]))
        # preserve insertion order, drop duplicates from straddling items
        seen, uniq = set(), []
        for i in out:
            if i not in seen:
                seen.add(i)
                uniq.append(i)
        return uniq

    @property
    def n_nodes(self):
        return len(self._axis)

    # --- serialisation (kdtree3d.pyx:155-164 save/load) -------------------

    def save(self, path):
        np.savez_compressed(
            path, axis=self._axis, split=self._split,
            upper_child=self._upper_child, leaf_start=self._leaf_start,
            leaf_count=self._leaf_count, leaf_items=self._leaf_items,
            ids=self._ids, lower=self._bounds_lower,
            upper=self._bounds_upper, min_items=self.min_items,
        )

    @classmethod
    def load(cls, path):
        d = np.load(path)
        tree = cls.__new__(cls)
        tree._axis = d["axis"]
        tree._split = d["split"]
        tree._upper_child = d["upper_child"]
        tree._leaf_start = d["leaf_start"]
        tree._leaf_count = d["leaf_count"]
        tree._leaf_items = d["leaf_items"]
        tree._ids = d["ids"]
        tree._bounds_lower = d["lower"]
        tree._bounds_upper = d["upper"]
        tree.min_items = int(d["min_items"])
        return tree


class KDTree3D(_KDTreeCore):
    """3D kd-tree over item AABBs (kdtree3d.pyx:103)."""

    _ndim = 3

    @staticmethod
    def _lower(box):
        lo = box.lower
        return [lo.x, lo.y, lo.z] if hasattr(lo, "x") else list(lo)

    @staticmethod
    def _upper(box):
        up = box.upper
        return [up.x, up.y, up.z] if hasattr(up, "x") else list(up)

    @staticmethod
    def _point_array(point):
        if hasattr(point, "x"):
            return np.asarray([point.x, point.y, point.z], np.float64)
        return np.asarray(point, np.float64)


class KDTree2D(_KDTreeCore):
    """2D kd-tree over item AABBs (kdtree2d.pyx:101)."""

    _ndim = 2

    @staticmethod
    def _lower(box):
        lo = box.lower
        return [lo.x, lo.y] if hasattr(lo, "x") else list(lo)

    @staticmethod
    def _upper(box):
        up = box.upper
        return [up.x, up.y] if hasattr(up, "x") else list(up)

    @staticmethod
    def _point_array(point):
        if hasattr(point, "x"):
            return np.asarray([point.x, point.y], np.float64)
        return np.asarray(point, np.float64)
