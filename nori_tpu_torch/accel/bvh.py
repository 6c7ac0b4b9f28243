"""Host-side BVH construction.

Binned-SAH binary BVH (16 bins, largest-centroid-extent axis) collapsed
into an 8-wide layout for TPU wavefront traversal.  Triangles are
reordered so every leaf is a contiguous [start, count] range with
count <= LEAF_SIZE; the caller applies the returned permutation to all
per-triangle arrays (nori_tpu_torch.scene.Scene.compile).

Replaces the reference's assignment-level octree/BVH (accel.h:26-71,
SURVEY.md §2.14); shallow-and-wide instead of deep-and-binary because
TPU traversal cost is per *step* (gather + 8 vectorized box tests), so
minimizing tree depth matters more than minimizing node tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_SIZE = 8
WIDTH = 8
N_BINS = 16


@dataclass
class WideBVH:
    child: np.ndarray  # (NODES, W) int32: interior -> node id; leaf -> tri start
    count: np.ndarray  # (NODES, W) int32: -1 empty, 0 interior, >0 leaf count
    bmin: np.ndarray   # (NODES, W, 3) float32
    bmax: np.ndarray   # (NODES, W, 3) float32

    @property
    def num_nodes(self):
        return self.child.shape[0]


class _Node2:
    __slots__ = ("bmin", "bmax", "left", "right", "start", "count")

    def __init__(self, bmin, bmax, left=None, right=None, start=-1, count=0):
        self.bmin, self.bmax = bmin, bmax
        self.left, self.right = left, right
        self.start, self.count = start, count

    @property
    def is_leaf(self):
        return self.left is None

    def surface_area(self):
        d = np.maximum(self.bmax - self.bmin, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _build2(order, start, end, cmin, cmax, centroids, bmin_t, bmax_t):
    """Recursively build a binary BVH over order[start:end]; returns _Node2."""
    idx = order[start:end]
    nb_min = bmin_t[idx].min(axis=0)
    nb_max = bmax_t[idx].max(axis=0)
    count = end - start
    if count <= LEAF_SIZE:
        return _Node2(nb_min, nb_max, start=start, count=count)

    c = centroids[idx]
    c_min, c_max = c.min(axis=0), c.max(axis=0)
    extent = c_max - c_min
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        # all centroids identical: median split
        mid = start + count // 2
        left = _build2(order, start, mid, None, None, centroids, bmin_t, bmax_t)
        right = _build2(order, mid, end, None, None, centroids, bmin_t, bmax_t)
        return _Node2(nb_min, nb_max, left=left, right=right)

    # binned SAH
    scale = N_BINS * (1.0 - 1e-6) / extent[axis]
    bins = np.minimum(
        ((c[:, axis] - c_min[axis]) * scale).astype(np.int32), N_BINS - 1
    )
    bin_counts = np.bincount(bins, minlength=N_BINS)
    INF = np.float64(np.inf)
    bin_bmin = np.full((N_BINS, 3), INF)
    bin_bmax = np.full((N_BINS, 3), -INF)
    for b in range(N_BINS):
        m = bins == b
        if bin_counts[b]:
            bin_bmin[b] = bmin_t[idx[m]].min(axis=0)
            bin_bmax[b] = bmax_t[idx[m]].max(axis=0)

    # prefix/suffix areas
    def _area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    pre_min = np.minimum.accumulate(bin_bmin, axis=0)
    pre_max = np.maximum.accumulate(bin_bmax, axis=0)
    suf_min = np.minimum.accumulate(bin_bmin[::-1], axis=0)[::-1]
    suf_max = np.maximum.accumulate(bin_bmax[::-1], axis=0)[::-1]
    pre_cnt = np.cumsum(bin_counts)
    suf_cnt = count - pre_cnt

    cost = np.full(N_BINS - 1, np.inf)
    for s in range(N_BINS - 1):
        nl, nr = pre_cnt[s], suf_cnt[s]
        if nl == 0 or nr == 0:
            continue
        al = _area(pre_min[s:s + 1], pre_max[s:s + 1])[0]
        ar = _area(suf_min[s + 1:s + 2], suf_max[s + 1:s + 2])[0]
        cost[s] = al * nl + ar * nr
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        mid = start + count // 2
        part = np.argsort(c[:, axis], kind="stable")
        order[start:end] = idx[part]
    else:
        go_left = bins <= best
        order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
        mid = start + int(np.count_nonzero(go_left))

    left = _build2(order, start, mid, None, None, centroids, bmin_t, bmax_t)
    right = _build2(order, mid, end, None, None, centroids, bmin_t, bmax_t)
    return _Node2(nb_min, nb_max, left=left, right=right)


def _collapse(root: _Node2):
    """Collapse a binary BVH into WIDTH-ary nodes (greedy largest-area
    expansion), emitting flat arrays."""
    child_rows, count_rows, bmin_rows, bmax_rows = [], [], [], []
    # BFS with node-id assignment
    pending = [root]
    ids = {id(root): 0}
    while pending:
        node = pending.pop(0)
        # gather up to WIDTH children by splitting interior nodes
        children = [node.left, node.right]
        while len(children) < WIDTH:
            # expand the interior child with the largest surface area
            best_i, best_a = -1, -1.0
            for i, ch in enumerate(children):
                if not ch.is_leaf:
                    a = ch.surface_area()
                    if a > best_a:
                        best_i, best_a = i, a
            if best_i < 0:
                break
            ch = children.pop(best_i)
            children.extend([ch.left, ch.right])

        row_child = np.full(WIDTH, -1, dtype=np.int32)
        row_count = np.full(WIDTH, -1, dtype=np.int32)
        row_bmin = np.zeros((WIDTH, 3), dtype=np.float32)
        row_bmax = np.zeros((WIDTH, 3), dtype=np.float32)
        for i, ch in enumerate(children):
            if ch.is_leaf and ch.count == 0:
                continue  # empty slot
            row_bmin[i] = ch.bmin
            row_bmax[i] = ch.bmax
            if ch.is_leaf:
                row_child[i] = ch.start
                row_count[i] = ch.count
            else:
                nid = len(ids) if id(ch) not in ids else ids[id(ch)]
                if id(ch) not in ids:
                    ids[id(ch)] = nid
                    pending.append(ch)
                row_child[i] = nid
                row_count[i] = 0
        child_rows.append(row_child)
        count_rows.append(row_count)
        bmin_rows.append(row_bmin)
        bmax_rows.append(row_bmax)

    return WideBVH(
        child=np.stack(child_rows),
        count=np.stack(count_rows),
        bmin=np.stack(bmin_rows),
        bmax=np.stack(bmax_rows),
    )


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Build over a triangle soup; returns (order, WideBVH).

    `order` is the new-to-old triangle permutation: apply
    `arr = arr[order]` to every per-triangle array so leaves address
    contiguous ranges.
    """
    T = v0.shape[0]
    # fast path: native C++ builder (same algorithm, ~50x faster)
    if T > LEAF_SIZE:
        from nori_tpu_torch import native

        built = native.bvh_build(v0, e1, e2)
        if built is not None:
            order, child, count, bmin, bmax = built
            return order.astype(np.int64), WideBVH(
                child=child, count=count,
                bmin=bmin.astype(np.float32), bmax=bmax.astype(np.float32),
            )

    p1, p2 = v0 + e1, v0 + e2
    bmin_t = np.minimum(np.minimum(v0, p1), p2).astype(np.float64)
    bmax_t = np.maximum(np.maximum(v0, p1), p2).astype(np.float64)
    centroids = (v0 + p1 + p2) / 3.0

    order = np.arange(T)
    if T <= LEAF_SIZE:
        # single-leaf scene: a root with one leaf child
        root = _Node2(
            bmin_t.min(0), bmax_t.max(0),
            left=_Node2(bmin_t.min(0), bmax_t.max(0), start=0, count=T),
            right=_Node2(
                np.full(3, np.inf), np.full(3, -np.inf), start=0, count=0
            ),
        )
        wide = _collapse(root)
        return order, wide

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        root = _build2(order, 0, T, None, None, centroids, bmin_t, bmax_t)
    finally:
        sys.setrecursionlimit(old_limit)
    if root.is_leaf:
        root = _Node2(
            root.bmin, root.bmax, left=root,
            right=_Node2(np.full(3, np.inf), np.full(3, -np.inf), start=0, count=0),
        )
    wide = _collapse(root)
    return order, wide
