"""Ray-triangle queries of the reference: a stack walk of its binary BVH
in plain PyTorch, testing each leaf's triangles by the renderer's
triangle test: Nori's Mesh::rayIntersect conditions (src/mesh.cpp:51-88:
|det| > 1e-8, u in [0, 1], v >= 0, u + v <= 1, t in [mint, maxt]) on
the Baldwin-Weber form of the triangle (`scene._bw_rows`), each sum
taken left to right in float32.  Shadow rays start on a surface, 1e-4
along, so whether a neighbouring triangle a few ulps away occludes them
turns on how t rounds: the reference rounds it as the renderer states.
The closest hit keeps the lowest triangle index on a tie in t, and its
barycentrics are taken again by Moller-Trumbore, clipped to [0, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.shading import cross

STACK_DEPTH = 64
LEAF_LANES = 8


class Hit(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def _dot3(r, a, x):
    """r[..., a] * x0 + r[..., a+1] * x1 + r[..., a+2] * x2, left to
    right."""
    return (r[..., a] * x[..., 0] + r[..., a + 1] * x[..., 1]
            + r[..., a + 2] * x[..., 2])


def _baldwin_weber(r, o, d, mint, maxt):
    """Hit and t of rays (o, d) against triangles of rows r (..., 12)."""
    den = _dot3(r, 0, d)
    ok = torch.abs(den) > 1e-8
    inv_den = 1.0 / torch.where(ok, den, 1.0)
    t = -(_dot3(r, 0, o) + r[..., 3]) * inv_den
    p = o + t[..., None] * d
    u = _dot3(r, 4, p) + r[..., 7]
    v = _dot3(r, 8, p) + r[..., 11]
    hit = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint) & (t <= maxt))
    return hit, t


def _box(rs, node, o, inv_d, mint, maxt):
    t0 = (rs.node_bmin[node] - o) * inv_d
    t1 = (rs.node_bmax[node] - o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tmin <= tmax) & (tmax >= mint) & (tmin <= maxt), tmin


def _barycentrics(rs, tri, o, d):
    """(u, v) of each ray on its triangle, clipped to [0, 1] (the form
    the renderer rebuilds its hit point from)."""
    v0, e1, e2 = rs.v0[tri], rs.e1[tri], rs.e2[tri]
    pv = cross(d, e2)
    det = torch.sum(e1 * pv, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    tv = o - v0
    u = torch.clamp(torch.sum(tv * pv, dim=-1) * inv_det, 0.0, 1.0)
    qv = cross(tv, e1)
    v = torch.clamp(torch.sum(d * qv, dim=-1) * inv_det, 0.0, 1.0)
    return u, v


def intersect(rs, o, d, mint, maxt, active, any_hit: bool = False) -> Hit:
    """Closest hit (or, with any_hit, whether any hit) of each active
    ray in [mint, maxt]; inactive rays miss."""
    n, dev = o.shape[0], o.device
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(LEAF_LANES, device=dev)
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
    stack = torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)
    best_t = maxt.clone()
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    while True:
        walking = sp > 0
        if any_hit:
            walking = walking & (best_i < 0)
        if not bool(walking.any()):
            break
        top = stack[rows, torch.clamp_min(sp - 1, 0)]
        sp = torch.where(walking, sp - 1, sp)
        cnt = rs.node_count[top]
        inner = walking & (cnt == 0)
        leaf = walking & (cnt > 0)

        # inner node: push the children whose boxes the ray enters,
        # the nearer last so that it is popped first
        lc = torch.clamp_min(rs.node_left[top], 0)
        rc = torch.clamp_min(rs.node_right[top], 0)
        hl, tl = _box(rs, lc, o, inv_d, mint, best_t)
        hr, tr = _box(rs, rc, o, inv_d, mint, best_t)
        hl, hr = hl & inner, hr & inner
        l_near = tl <= tr
        for child, hit in ((torch.where(l_near, rc, lc),
                            torch.where(l_near, hr, hl)),
                           (torch.where(l_near, lc, rc),
                            torch.where(l_near, hl, hr))):
            slot = torch.where(hit & (sp < STACK_DEPTH), sp, STACK_DEPTH)
            stack[rows, slot] = child
            sp = sp + (hit & (sp < STACK_DEPTH)).to(torch.int64)

        # leaf: test its triangles
        idx = rs.node_start[top][:, None] + lanes[None, :]
        ok = leaf[:, None] & (lanes[None, :] < cnt[:, None])
        gi = torch.where(ok, idx, 0)
        hit, t = _baldwin_weber(rs.bw[gi], o[:, None], d[:, None],
                                mint[:, None], best_t[:, None])
        hit = hit & ok
        t = torch.where(hit, t, float("inf"))
        tmin = torch.amin(t, dim=1)
        imin = torch.amin(torch.where(hit & (t == tmin[:, None]), idx, big),
                          dim=1)
        found = torch.any(hit, dim=1)
        better = found & ((tmin < best_t) | ((tmin == best_t) & (
            (best_i < 0) | (imin < best_i))))
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin, best_i)
    valid = best_i >= 0
    if any_hit:
        return Hit(valid, best_t, best_i, None, None)
    tri = torch.clamp_min(best_i, 0)
    u, v = _barycentrics(rs, tri, o, d)
    u = torch.where(valid, u, 0.0)
    v = torch.where(valid, v, 0.0)
    return Hit(valid, best_t, best_i, u, v)
