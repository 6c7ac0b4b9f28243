"""Binned-SAH BVH over a triangle soup, built level by level in numpy.

The renderer's sample values depend on the order of its triangles: area
lights are sampled through a CDF over the emissive triangles in that
order.  The program orders its soup by a binned-SAH BVH (16 bins, the
axis of the largest centroid extent, leaves of at most 8 triangles,
float32 arithmetic throughout, ties in cost going to the higher split,
a stable partition).  This builder makes the same decisions, node for
node, but splits every node of a level at once, so a scene of half a
million triangles builds in seconds; it raises where the rule it
reproduces has no answer (no split with triangles on both sides).

The binary tree it returns is also what `trace.py` walks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 8
N_BINS = 16
_F = np.float32
_BIG = _F(1e30)


class Tree(NamedTuple):
    """Binary BVH: per node its children (-1 at a leaf), the leaf's
    triangle range in `order`, and its box."""

    order: np.ndarray   # (T,) new -> old triangle permutation
    left: np.ndarray    # (N,) int64
    right: np.ndarray   # (N,) int64
    start: np.ndarray   # (N,) int64
    count: np.ndarray   # (N,) int64, 0 at inner nodes
    bmin: np.ndarray    # (N, 3) float32
    bmax: np.ndarray    # (N, 3) float32


def _area(lo, hi):
    d0 = np.maximum(_F(0), hi[..., 0] - lo[..., 0])
    d1 = np.maximum(_F(0), hi[..., 1] - lo[..., 1])
    d2 = np.maximum(_F(0), hi[..., 2] - lo[..., 2])
    return _F(2) * (d0 * d1 + d1 * d2 + d2 * d0)


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> Tree:
    """BVH over float32 (T, 3) corner and edge arrays."""
    v0, e1, e2 = (np.asarray(a, _F) for a in (v0, e1, e2))
    p1, p2 = v0 + e1, v0 + e2
    tbmin = np.minimum(v0, np.minimum(p1, p2))
    tbmax = np.maximum(v0, np.maximum(p1, p2))
    cen = (v0 + p1 + p2) / _F(3)
    T = v0.shape[0]
    order = np.arange(T, dtype=np.int64)
    starts, ends, lefts, rights = [0], [T], [-1], [-1]
    frontier = np.array([0])
    scale_num = _F(N_BINS) * (_F(1) - _F(1e-6))
    while frontier.size:
        s = np.asarray(starts)[frontier]
        e = np.asarray(ends)[frontier]
        split = (e - s) > LEAF_SIZE
        frontier, s, e = frontier[split], s[split], e[split]
        if not frontier.size:
            break
        lens = e - s
        offs = np.cumsum(lens) - lens
        nseg = lens.size
        pos = np.repeat(s - offs, lens) + np.arange(lens.sum())
        seg = np.repeat(np.arange(nseg), lens)
        tri = order[pos]
        c = cen[tri]
        cmin = np.minimum.reduceat(c, offs, axis=0)
        cmax = np.maximum.reduceat(c, offs, axis=0)
        ext = cmax - cmin
        axis = np.argmax(ext, axis=1)
        ext_a = ext[np.arange(nseg), axis]
        flat = ext_a <= _F(1e-12)
        scale = scale_num / np.where(flat, _F(1), ext_a)
        ca = c[np.arange(c.shape[0]), axis[seg]]
        b = ((ca - cmin[seg, axis[seg]]) * scale[seg]).astype(np.int64)
        b = np.minimum(b, N_BINS - 1)
        key = seg * N_BINS + b
        cnt = np.bincount(key, minlength=nseg * N_BINS).reshape(
            nseg, N_BINS)
        bmn = np.full((nseg * N_BINS, 3), _BIG, _F)
        bmx = np.full((nseg * N_BINS, 3), -_BIG, _F)
        np.minimum.at(bmn, key, tbmin[tri])
        np.maximum.at(bmx, key, tbmax[tri])
        bmn = bmn.reshape(nseg, N_BINS, 3)
        bmx = bmx.reshape(nseg, N_BINS, 3)
        pre_area = _area(np.minimum.accumulate(bmn, axis=1),
                         np.maximum.accumulate(bmx, axis=1))
        suf_area = _area(np.minimum.accumulate(bmn[:, ::-1], axis=1)[:, ::-1],
                         np.maximum.accumulate(bmx[:, ::-1], axis=1)[:, ::-1])
        pre_cnt = np.cumsum(cnt, axis=1)
        nl = pre_cnt[:, :-1]                     # split after bin k
        nr = lens[:, None] - nl
        cost = (pre_area[:, :-1] * nl.astype(_F)
                + suf_area[:, 1:] * nr.astype(_F))
        cost = np.where((nl > 0) & (nr > 0) & (cost < _BIG), cost, np.inf)
        cmin_cost = cost.min(axis=1)
        ties = cost == cmin_cost[:, None]
        best = N_BINS - 2 - np.argmax(ties[:, ::-1], axis=1)
        if np.any(~flat & ~np.isfinite(cmin_cost)):
            raise RuntimeError("reference BVH: a node has no split with "
                               "triangles on both sides")
        right = (b > best[seg]) & ~flat[seg]
        perm = np.argsort(seg * 2 + right, kind="stable")
        order[pos] = tri[perm]
        n_left = lens - np.bincount(seg, weights=right,
                                    minlength=nseg).astype(np.int64)
        one_side = (n_left == 0) | (n_left == lens) | flat
        mid = np.where(one_side, s + lens // 2, s + n_left)
        new = []
        for node, st, md, en in zip(frontier.tolist(), s.tolist(),
                                    mid.tolist(), e.tolist()):
            lefts[node] = len(starts)
            starts.append(st), ends.append(md), lefts.append(-1)
            rights.append(-1)
            rights[node] = len(starts)
            starts.append(md), ends.append(en), lefts.append(-1)
            rights.append(-1)
            new += [lefts[node], rights[node]]
        frontier = np.asarray(new, dtype=np.int64)
    left = np.asarray(lefts, np.int64)
    right = np.asarray(rights, np.int64)
    start = np.asarray(starts, np.int64)
    count = np.where(left < 0, np.asarray(ends, np.int64) - start, 0)
    # boxes: leaves from their triangles, inner nodes from their children
    n = left.size
    bmin = np.full((n, 3), np.inf, _F)
    bmax = np.full((n, 3), -np.inf, _F)
    leaf = np.nonzero(count > 0)[0]
    lo = tbmin[order]
    hi = tbmax[order]
    srt = np.argsort(start[leaf])
    leaf = leaf[srt]
    bmin[leaf] = np.minimum.reduceat(lo, start[leaf], axis=0)
    bmax[leaf] = np.maximum.reduceat(hi, start[leaf], axis=0)
    for node in range(n - 1, -1, -1):   # children have higher ids
        if left[node] >= 0:
            bmin[node] = np.minimum(bmin[left[node]], bmin[right[node]])
            bmax[node] = np.maximum(bmax[left[node]], bmax[right[node]])
    return Tree(order, left, right, start, count, bmin, bmax)
