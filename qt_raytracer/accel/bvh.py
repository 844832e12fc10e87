"""BVH build (host) + flattened escape-index layout for batched traversal.

The reference's BVH is a pointer tree of shared_ptr nodes with a *recursive*
hit routine (RayTracer.h:374-439): random split axis, sort by box min, median
split. Pointer chasing and recursion don't exist under XLA, so the build (host
side, numpy — or the native C++ builder in native/) flattens the tree to SoA
arrays in depth-first order with ESCAPE indices:

    node i hit  -> continue to i+1 (its first child / next in DFS)
    node i miss -> jump to escape[i] (the next subtree to the right)

which turns traversal into a single-pointer while loop per ray — no stack,
no recursion (SURVEY.md §7 "hard parts"). Leaves reference a contiguous run
of REORDERED primitives, so leaf processing is a dense slice, not a gather
of scattered ids.

Split policy: largest-extent axis + centroid median (deterministic, balanced;
the reference's random-axis choice adds variance for no benefit. The native
builder upgrades this to binned SAH.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FlatBVH(NamedTuple):
    """SoA BVH. M nodes, DFS order. All numpy (host) or jnp (device) arrays.

    leaf nodes: prim_count > 0, prims in [prim_start, prim_start+prim_count)
    inner nodes: prim_count == 0, first child at i+1, sibling via escape.
    escape[i]: node index to jump to when box i is missed (M = "done").
    """

    bbox_min: np.ndarray     # [M, 3]
    bbox_max: np.ndarray     # [M, 3]
    escape: np.ndarray       # [M] i32
    prim_start: np.ndarray   # [M] i32
    prim_count: np.ndarray   # [M] i32
    prim_order: np.ndarray   # [P] i32: original prim id at sorted position


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
              max_leaf: int = 4) -> FlatBVH:
    """Build from per-primitive AABBs [P,3]. Returns the flat escape layout."""
    p = bb_min.shape[0]
    if p == 0:
        raise ValueError("BVH requires at least one primitive")  # RayTracer.h:399
    centroids = 0.5 * (bb_min + bb_max)
    order = np.arange(p)

    # Recursive build into python lists, then freeze.
    nodes = []  # [bmin, bmax, start, count, left_child(to fix), ...]

    def rec(ids) -> int:
        my = len(nodes)
        bmin = bb_min[ids].min(0)
        bmax = bb_max[ids].max(0)
        nodes.append([bmin, bmax, -1, 0, None])  # placeholder
        if len(ids) <= max_leaf:
            nodes[my][2] = rec.cursor
            nodes[my][3] = len(ids)
            out_order[rec.cursor:rec.cursor + len(ids)] = ids
            rec.cursor += len(ids)
            return my
        axis = int(np.argmax(bmax - bmin))
        med = np.argsort(centroids[ids, axis], kind="stable")
        half = len(ids) // 2
        left_ids, right_ids = ids[med[:half]], ids[med[half:]]
        rec(left_ids)
        right = rec(right_ids)
        nodes[my][4] = right  # right child index (== left subtree escape)
        return my

    out_order = np.empty(p, np.int64)
    rec.cursor = 0
    rec(order)

    m = len(nodes)
    bbox_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    bbox_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    prim_start = np.array([n[2] for n in nodes], np.int32)
    prim_count = np.array([n[3] for n in nodes], np.int32)

    # escape[i]: for each node, the DFS index of the next subtree when this
    # node's box is missed (or its subtree is done).
    escape = np.full(m, m, np.int32)

    def fill_escape(i: int, esc: int) -> None:
        escape[i] = esc
        if nodes[i][3] == 0:  # inner: children are i+1 and nodes[i][4]
            right = nodes[i][4]
            fill_escape(i + 1, right)   # left's escape -> right subtree
            fill_escape(right, esc)     # right's escape -> parent's escape

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * m + 100))
    try:
        fill_escape(0, m)
    finally:
        sys.setrecursionlimit(old)

    return FlatBVH(bbox_min=bbox_min, bbox_max=bbox_max, escape=escape,
                   prim_start=prim_start, prim_count=prim_count,
                   prim_order=out_order.astype(np.int32))


def validate_bvh(bvh: FlatBVH, bb_min: np.ndarray, bb_max: np.ndarray) -> None:
    """Structural invariants (used by tests): coverage, containment, escapes."""
    m = len(bvh.escape)
    p = len(bvh.prim_order)
    assert sorted(bvh.prim_order.tolist()) == list(range(p))
    leaf = bvh.prim_count > 0
    # Every primitive appears in exactly one leaf run.
    covered = np.zeros(p, bool)
    for i in np.nonzero(leaf)[0]:
        s, c = int(bvh.prim_start[i]), int(bvh.prim_count[i])
        assert not covered[s:s + c].any()
        covered[s:s + c] = True
        # Leaf box contains its primitives' boxes.
        ids = bvh.prim_order[s:s + c]
        assert (bb_min[ids] >= bvh.bbox_min[i] - 1e-5).all()
        assert (bb_max[ids] <= bvh.bbox_max[i] + 1e-5).all()
    assert covered.all()
    assert (bvh.escape > np.arange(m)).all() and (bvh.escape <= m).all()
