"""The analytic-BVH kernel's records and its own walk, in source_tpu_torch.

The kernel ``analytic_bvh_winner`` (csrc/analytic_bvh.cu) reads records
packed from the BVH tables (``pack_bvh_records``): node rows, item rows with
each item's box, CSG child rows and each CSG signature's truth table. It
tests an item only where the ray enters the item's box, and resolves a CSG
item from the truth table. ``pruned_walk_plain`` is that walk in torch; the
specification is ``analytic_bvh_winner_plain`` (the threaded walk), which
tests/test_torch_wavefront.py holds against the JAX package's kernel. These
tests close the chain on the CPU with no JAX: the truth tables equal their
programs at every state, every field of a record equals its table's, every
tightened CSG box holds its entity's hits, and the pruned walk returns the
specification's winners.

Inputs: the CSG demo (``scenes.csg_world``), 4 096 of its 512x512 camera
rays picked by a numpy seed, and ``scenes.leaf_field`` (256 simple leaves of
all six types, 8 lens CSGs) with 4 096 ``field_rays``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.compiler.scene import _program_to_closure
from source_tpu_torch.primitive.analytic import TYPE_TORUS
from source_tpu_torch.primitive.shapes import (OP_INTERSECT, OP_LEAF,
                                               OP_SUBTRACT, OP_UNION)
from source_tpu_torch.tracer import analytic_bvh as B

N_RAYS = 4096
KEYS = ("leaf", "entity", "inside", "crossing_hi")
# t and normal off the torus: rtol / atol. The two walks do the same
# arithmetic on each lane, so these are equal bit for bit in practice.
RTOL, ATOL = 1e-6, 1e-7
# On a torus winner: PyTorch's CPU loops round the quartic's cube root and
# arccos by the lane's position in an evaluation (a SIMD body with SLEEF, a
# scalar tail with libm), the two walks evaluate the torus over different
# lane sets, and the f32 quartic amplifies that ulp (ROADMAP queue 3). As
# chip_smoke.py holds the kernel there: where both walks choose the same
# torus, the pruned walk's t is at most F64_FACTOR times as far from the
# specification evaluated in float64 as the specification's own, plus
# F64_ATOL; a grazing hit may be found by one walk only, on at most MAX_FLIP
# of the rays.
F64_FACTOR, F64_ATOL = 2.0, 1e-4
MAX_FLIP = 0.005
_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        world = {"csg_demo": scenes.csg_world,
                 "leaf_field": scenes.leaf_field}[name]
        _SCENES[name] = T.compile_scene(
            world(), T.SpectralConfig(375.0, 740.0, 1), device="cpu")
    return _SCENES[name]


def _rays(name):
    if name == "csg_demo":
        o, d = scenes.camera_rays(512, 512, 75.0, (0.0, 0.0, -4.0))
        pick = np.random.RandomState(8).choice(len(o), N_RAYS, replace=False)
        o, d = o[pick], d[pick]
    else:
        o, d = scenes.field_rays(N_RAYS, seed=8)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    return o, d, 1e-4 * torch.clamp(o.abs().amax(-1), min=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The walks are many small tensor ops: one thread runs them fastest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["csg_demo", "leaf_field"])
def case(request, one_thread):
    """(name, scene, records, rays, the specification's and the pruned
    walk's results)."""
    scene = _scene(request.param)
    rec = B.bvh_records(scene.leaf_bvh, scene.leaf_bvh_meta)
    o, d, eps = _rays(request.param)
    spec = B.analytic_bvh_winner_plain(scene.leaf_bvh, scene.leaf_bvh_meta,
                                       o, d, eps)
    walk = B.pruned_walk_plain(rec, o, d, eps)
    return request.param, scene, rec, (o, d, eps), spec, walk


def _random_program(n, rng):
    """A postfix CSG program over local children 0..n-1, each once: a random
    binary tree of random operators."""
    parts = [[(OP_LEAF, int(c))] for c in rng.permutation(n)]
    while len(parts) > 1:
        i, j = rng.choice(len(parts), 2, replace=False)
        a, b = parts[i], parts[j]
        parts = [p for k, p in enumerate(parts) if k not in (i, j)]
        parts.append(a + b + [(int(rng.choice([OP_UNION, OP_INTERSECT,
                                                OP_SUBTRACT])), 0)])
    return parts[0]


def _assert_truth_table(program, n):
    tt = B.truth_table(program, n)
    states = torch.tensor([[(s >> k) & 1 for k in range(n)]
                           for s in range(1 << n)], dtype=torch.bool)
    want = _program_to_closure(program)(states)
    got = torch.tensor([(tt >> s) & 1 for s in range(1 << n)], dtype=torch.bool)
    assert torch.equal(got, want)
    assert tt < (1 << (1 << n))


@pytest.mark.parametrize("name", ["csg_demo", "leaf_field"])
def test_truth_table_scene_signatures(name):
    sigs = _scene(name).leaf_bvh_meta[6]
    assert sigs
    for program, child_types in sigs:
        _assert_truth_table(program, len(child_types))


@pytest.mark.parametrize("seed", range(6))
def test_truth_table_random_programs(seed):
    rng = np.random.RandomState(seed)
    n = seed % B.MAX_CSG_CHILD + 1
    for _ in range(4):
        _assert_truth_table(_random_program(n, rng), n)


def test_records_equal_their_tables(case):
    _name, scene, rec, _r, _s, _w = case
    tab, meta = scene.leaf_bvh, scene.leaf_bvh_meta
    nodes, leaves, csg = tab["nodes"], tab["leaves"], tab["csg"]
    i32 = torch.int32
    nb = rec.nodes.view(i32)
    assert rec.nodes.shape == (meta[0], B.NODE_W)
    assert torch.equal(rec.nodes[:, 0:3], nodes[:, 0:3])
    assert torch.equal(rec.nodes[:, 4:7], nodes[:, 3:6])
    assert torch.equal(nb[:, 3], nodes[:, 6].to(i32))
    assert torch.equal(nb[:, 7] >> 8, nodes[:, 7].to(i32))
    assert torch.equal(nb[:, 7] & 255, nodes[:, 8].to(i32))
    ib = rec.items.view(i32)
    kind = leaves[:, 20].to(i32)
    csg_rows = kind == B.KT_CSG
    row = leaves[csg_rows, 0].long()
    box = tab["item_box"].clone()
    box[csg_rows] = tab["csg_box"][row]
    assert torch.equal(rec.items[:, 0:3], box[:, 0:3])
    assert torch.equal(rec.items[:, 4:7], box[:, 3:6])
    assert torch.equal(ib[:, 3], kind)
    assert torch.equal(ib[:, 7], leaves[:, 22].to(i32))
    rec_part = rec.items[:, B._REC:B._REC + 23]
    assert torch.equal(rec_part[~csg_rows], leaves[~csg_rows])
    assert torch.equal(rec_part[csg_rows, 5:], leaves[csg_rows, 5:])
    # CSG payload: first child row, child count, truth table
    sig = leaves[csg_rows, 1].long()
    pay = ib[csg_rows, B._REC:B._REC + 4]
    assert torch.equal(pay[:, 0].long(), row * B.MAX_CSG_CHILD)
    assert torch.equal(rec_part[csg_rows, 4], leaves[csg_rows, 4])
    assert not rec.items[:, 31].any()
    for words, s in zip(pay.numpy().view(np.uint32), sig.tolist()):
        program, types = meta[6][s]
        assert int(words[1]) == len(types)
        assert (int(words[2]) | (int(words[3]) << 32)
                == B.truth_table(program, len(types)))
    # child rows: the CSG table's children, with their types
    kb = rec.children.view(i32)
    for j, s in zip(row.tolist(), sig.tolist()):
        types = meta[6][s][1]
        assert int(csg[j, 0]) == len(types)
        for c, tid in enumerate(types):
            r, base = j * B.MAX_CSG_CHILD + c, 1 + 21 * c
            assert torch.equal(rec.children[r, 0:20], csg[j, base + 1:base + 21])
            assert int(kb[r, 20]) == int(csg[j, base])
            assert int(kb[r, 21]) == tid
            assert not rec.children[r, 22:].any()


def test_item_boxes_are_the_bvh_boxes(case):
    """Every item box lies inside its leaf node's box, and each CSG box
    inside the union of its children's that the BVH was built over."""
    _name, scene, rec, _r, _s, _w = case
    tab = scene.leaf_bvh
    nodes = tab["nodes"]
    for n in torch.nonzero(nodes[:, 8] > 0).flatten().tolist():
        a, c = int(nodes[n, 7]), int(nodes[n, 8])
        assert (tab["item_box"][a:a + c, :3] >= nodes[n, :3]).all()
        assert (tab["item_box"][a:a + c, 3:] <= nodes[n, 3:6]).all()
    csg_rows = tab["leaves"][:, 20] == B.KT_CSG
    cbox = tab["csg_box"][tab["leaves"][csg_rows, 0].long()]
    ubox = tab["item_box"][csg_rows]
    assert (cbox[:, :3] >= ubox[:, :3]).all() and (cbox[:, 3:] <= ubox[:, 3:]).all()


def test_csg_boxes_hold_their_hits(case):
    """The spec's winning crossing of every kernel-resolved CSG entity lies
    in that entity's tightened box."""
    _name, scene, rec, (o, d, _e), spec, _w = case
    leaves = scene.leaf_bvh["leaves"]
    csg_rows = leaves[:, 20] == B.KT_CSG
    box_of = {int(e): scene.leaf_bvh["csg_box"][int(j)]
              for e, j in zip(leaves[csg_rows, 22], leaves[csg_rows, 0])}
    hits = 0
    for e, box in box_of.items():
        on = (spec["entity"] == e) & (spec["leaf"] >= 0)
        p = o[on] + spec["t"][on, None] * d[on]
        assert ((p >= box[:3]) & (p <= box[3:])).all(), e
        hits += int(on.sum())
    assert hits > 0


def test_pruned_walk_matches_specification(case):
    name, scene, _rec, rays, spec, walk = case
    leaf_type = torch.zeros(scene.n_leaves, dtype=torch.int64)
    for tid, a, b in scene.type_slices:
        leaf_type[a:b] = tid
    torus = torch.zeros_like(spec["leaf"], dtype=torch.bool)
    for x in (spec, walk):
        torus |= (x["leaf"] >= 0) & (
            leaf_type[x["leaf"].clamp(min=0).long()] == TYPE_TORUS)
    same = torch.ones_like(torus)
    for k in KEYS:
        same &= walk[k] == spec[k]
    assert bool(same[~torus].all())
    assert int((~same).sum()) <= MAX_FLIP * len(same)
    hit = spec["leaf"] >= 0
    on = hit & ~torus
    torus &= same & hit
    assert ((walk["t"] - spec["t"]).abs()[on]
            <= ATOL + RTOL * spec["t"].abs()[on]).all()
    assert ((walk["normal"] - spec["normal"]).abs()[on]
            <= ATOL + RTOL * spec["normal"].abs()[on]).all()
    assert bool(hit.any()) and (name == "csg_demo") == (not bool(torus.any()))
    if bool(torus.any()):
        o, d, eps = (x[torus].double() for x in rays)
        tab64 = {k: scene.leaf_bvh[k].double() for k in ("nodes", "leaves", "csg")}
        s64 = B.analytic_bvh_winner_plain(tab64, scene.leaf_bvh_meta, o, d, eps)
        same64 = s64["leaf"] == spec["leaf"][torus]
        t64 = s64["t"][same64]
        dev_w = (walk["t"][torus][same64].double() - t64).abs().max()
        dev_s = (spec["t"][torus][same64].double() - t64).abs().max()
        assert dev_w <= F64_FACTOR * dev_s + F64_ATOL


def test_pruned_walk_work(case):
    """Off the torus the two walks visit the same nodes, and the pruned
    walk's item box tests are the threaded walk's item tests; it tests
    fewer items and evaluates fewer CSG children."""
    name, scene, _rec, _r, spec, walk = case
    same = torch.ones_like(spec["leaf"], dtype=torch.bool)
    if name == "leaf_field":
        # a torus t an ulp apart can change which nodes t_best prunes
        same = (spec["t"] == walk["t"]) & (spec["leaf"] == walk["leaf"])
    for a, b in (("nodes_visited", "nodes_visited"),
                 ("box_tests", "items_visited")):
        assert torch.equal(walk[a][same], spec[b][same]), a
    assert (walk["items_visited"] <= walk["box_tests"]).all()
    assert walk["items_visited"].sum() < walk["box_tests"].sum()
    assert walk["csg_children"].sum() < spec["csg_children"].sum()
    assert int(walk["kind_tests"].sum()) == int(walk["items_visited"].sum())


def test_records_without_item_boxes():
    """Tables without item boxes (the JAX package's) give each item its
    leaf node's box; the pruned walk still returns the specification's
    winners."""
    scene = _scene("csg_demo")
    tab = {k: scene.leaf_bvh[k] for k in ("nodes", "leaves", "csg")}
    rec = B.pack_bvh_records(tab, scene.leaf_bvh_meta)
    nodes = tab["nodes"]
    for n in torch.nonzero(nodes[:, 8] > 0).flatten().tolist():
        a, c = int(nodes[n, 7]), int(nodes[n, 8])
        assert torch.equal(rec.items[a:a + c, 0:3], nodes[n, 0:3].expand(c, 3))
        assert torch.equal(rec.items[a:a + c, 4:7], nodes[n, 3:6].expand(c, 3))
    o, d, eps = (x[:512] for x in _rays("csg_demo"))
    spec = B.analytic_bvh_winner_plain(tab, scene.leaf_bvh_meta, o, d, eps)
    walk = B.pruned_walk_plain(rec, o, d, eps)
    for k in KEYS + ("t", "normal"):
        assert torch.equal(walk[k], spec[k]), k


def test_records_follow_their_tables():
    """The records are packed once per set of tables and again after a
    table is edited in place."""
    scene = _scene("csg_demo")
    tab, meta = dict(scene.leaf_bvh), scene.leaf_bvh_meta
    first = B.bvh_records(tab, meta)
    assert B.bvh_records(tab, meta) is first
    tab["leaves"][0, 22] += 0.0  # an in-place edit bumps _version
    again = B.bvh_records(tab, meta)
    assert again is not first
    assert torch.equal(again.items, first.items)


def test_program_box():
    """Intersection, subtraction and union of boxes, and an empty solid as
    a NaN box that the walk's slab test rejects."""
    a = (np.array([0.0, 0.0, 0.0], np.float32), np.array([2.0, 2.0, 2.0], np.float32))
    b = (np.array([1.0, 1.0, 1.0], np.float32), np.array([3.0, 3.0, 3.0], np.float32))
    c = (np.array([5.0, 5.0, 5.0], np.float32), np.array([6.0, 6.0, 6.0], np.float32))
    leaf = [(OP_LEAF, 0), (OP_LEAF, 1)]
    np.testing.assert_array_equal(B._program_box(leaf + [(OP_INTERSECT, 0)], [a, b]),
                                  [1, 1, 1, 2, 2, 2])
    np.testing.assert_array_equal(B._program_box(leaf + [(OP_SUBTRACT, 0)], [a, b]),
                                  [0, 0, 0, 2, 2, 2])
    np.testing.assert_array_equal(B._program_box(leaf + [(OP_UNION, 0)], [a, b]),
                                  [0, 0, 0, 3, 3, 3])
    empty = B._program_box(leaf + [(OP_INTERSECT, 0)], [a, c])
    assert np.isnan(empty).all()
    # (A n C) u B is B's box; (A n C) - B stays empty
    three = [(OP_LEAF, 0), (OP_LEAF, 1), (OP_INTERSECT, 0), (OP_LEAF, 2)]
    np.testing.assert_array_equal(B._program_box(three + [(OP_UNION, 0)], [a, c, b]),
                                  [1, 1, 1, 3, 3, 3])
    assert np.isnan(B._program_box(three + [(OP_SUBTRACT, 0)], [a, c, b])).all()
    box = torch.as_tensor(empty)
    o = [torch.tensor([5.5])] * 3
    inv = [torch.tensor([1.0])] * 3
    assert not bool(B._slab_hit(box[:3], box[3:], o, inv, torch.tensor([3e38]))[0])


def _code(source):
    """A CUDA source of the port with its comments dropped."""
    src = (Path(B.__file__).parents[1] / "csrc" / source).read_text()
    return re.sub(r"//[^\n]*", "", src)


def test_k6_calls_the_fused_kernels_torus():
    """The torus hit has one body, ``fb::hit_torus`` (fused_bounce.cuh, its
    arguments and results by value), which K6 reaches through
    ``fb::hit_local``: K6 holds no quartic, root test or torus hit of its
    own, so a change to the torus moves the fused kernels and K6 together."""
    k6, fb = _code("analytic_bvh.cu"), _code("fused_bounce.cuh")
    for own in ("solve_quartic", "torus_root_valid", "TorusHit", "torus_hit",
                "hit_general"):
        assert own not in k6, own
    assert "fb::hit_local(" in k6
    local = fb[fb.index("float hit_local("):]
    local = local[:local.index("\n}\n")]
    assert "hit_torus(lo, ld, pp[0], pp[1], t_min)" in local
    assert fb.count("TorusHit hit_torus(V3 o, V3 d, float R, float r,") == 1
    assert fb.count("solve_quartic(a4, a3, a2, a1, a0, 3, roots)") == 1
