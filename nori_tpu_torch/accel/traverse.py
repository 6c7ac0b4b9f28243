"""Wavefront ray-scene intersection.

Port of the sweep path of `nori_tpu/accel/traverse.py`: `intersect`
(closest hit) and `occluded` (any hit) pack the rays, build the
per-ray-tile candidate keys (K1) and run the resident sweep (K2, or
K2-mxu on the matmul-form operand with config.USE_MXU_SWEEP) or, for
streamed-scale scenes (16-row operands, STREAM_T-triangle slab bounds,
as `Scene.compile_arrays` lays them out), the streamed sweep (K5, or
K5-cull with config.STREAM_CULL_T on the Moller-Trumbore operand),
gated by the scene's sub-block boxes (SceneData.tri_sub_boxes).  A
streamed scene's shadow query first sorts its rays by their own
candidate slabs (K3).  With spans on (nori_tpu_torch.spans), each
streamed sweep is a span `sweep.stream` and adds 1 to the counter
`sweeps.streamed`, and the shadow presort is a span `step.shadow_sort`;
K5's warps add the sub-blocks they test and skip to a tally on the
card, which a driver adds to the counters `sweeps.stream_groups` and
`sweeps.stream_groups_culled` once an image (count_gate_tally).
`intersect_mixed` runs both queries in one mixed launch (K4) for the
wavefront's merged step.  The switches in `nori_tpu_torch.config` are
read at every query.

config.accel_mode selects the backend (config.resolve_accel): the
sweeps above ("pallas"), or one of the JAX package's two other
backends in plain PyTorch: `intersect_brute` ("scan"), the whole soup
in chunks of 64 triangles, and `intersect_bvh` ("bvh"), a stack walk
of the wide BVH (scene.scene_bvh).  Under either, `intersect_mixed`
makes the two separate queries.

Triangle test semantics match Mesh::rayIntersect (src/mesh.cpp:51-88):
|det| > 1e-8, u in [0,1], v >= 0, u+v <= 1, t in [mint, maxt].
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from nori_tpu_torch import config, spans
from nori_tpu_torch.accel.bvh import LEAF_SIZE
from nori_tpu_torch.accel.sweep import (
    STREAM_G, TILE_N, cull_sub_blocks, lane_keys, pack_rays,
    ray_tile_entry_keys, resident_sweep, resident_sweep_mixed,
    resident_sweep_mxu, stream_sub_boxes, stream_sweep, stream_sweep_culled)
from nori_tpu_torch.core.vecmath import cross
from nori_tpu_torch.scene import scene_bvh

#: entries of the BVH walk's per-ray stack
STACK_DEPTH = 64
#: a leaf entry on the stack encodes -(start * LEAF_ENC + count) - 1
LEAF_ENC = 16
#: BVH walk steps taken before the host first reads whether a ray is
#: still walking; after them, one read per step
FIXED_STEPS = 40


class Hit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor      # (N,)
    tri: torch.Tensor    # (N,) int32 (-1 where !valid)
    u: torch.Tensor      # (N,)
    v: torch.Tensor      # (N,)


def _moller_trumbore(v0, e1, e2, o, d, mint, maxt):
    """Batched triangle test (traverse.py:40-56): v0/e1/e2 (..., 3)
    broadcast against o/d (..., 3); returns (hit, t, u, v)."""
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    ok = torch.abs(det) > 1e-8
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint) & (t <= maxt))
    return hit, t, u, v


def _take(x, j):
    """x[row, j[row]] for (N, K) x and (N,) j."""
    return torch.gather(x, 1, j[:, None]).squeeze(1)


def intersect_brute(sd, o, d, mint, maxt, chunk: int = 64) -> Hit:
    """Closest hit by scanning the whole soup, `chunk` triangles at a
    time (traverse.py:59-97): within a chunk the lowest index wins a tie
    in t, across chunks the earlier one (a later chunk must be strictly
    nearer).  T is a multiple of TRI_PAD, so of chunk."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    o3, d3 = o[:, None, :], d[:, None, :]
    lo, hi = mint[:, None], maxt[:, None]
    for c0 in range(0, sd.tri_v0.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        hit, t, u, v = _moller_trumbore(
            sd.tri_v0[None, sl], sd.tri_e1[None, sl], sd.tri_e2[None, sl],
            o3, d3, lo, hi)
        t = torch.where(hit, t, float("inf"))
        j = torch.argmin(t, dim=-1)
        tj = _take(t, j)
        better = tj < best_t
        best_i = torch.where(better, (c0 + j).to(torch.int32), best_i)
        best_u = torch.where(better, _take(u, j), best_u)
        best_v = torch.where(better, _take(v, j), best_v)
        best_t = torch.where(better, tj, best_t)
    return Hit(valid=best_i >= 0, t=best_t, tri=best_i, u=best_u, v=best_v)


def _ray_box(bmin, bmax, o, inv_d, mint, maxt):
    """Slab test (traverse.py:100-110): bmin/bmax (N, W, 3), o/inv_d
    (N, 1, 3), mint/maxt (N, 1); returns (hit (N, W), entry t)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tmin <= tmax) & (tmax >= mint) & (tmin <= maxt), tmin


def intersect_bvh(sd, o, d, mint, maxt, any_hit: bool = False,
                  fixed_steps: int = FIXED_STEPS) -> Hit:
    """Closest (or any) hit by a stack walk of the wide BVH
    (traverse.py:121-216).  Each step pops one entry per ray: an inner
    node box-tests its W children against (mint, best t) and pushes the
    hits, a leaf tests its <= LEAF_SIZE triangles; a leaf's nearest hit
    (lowest lane on a tie) replaces the best only when strictly nearer.
    Pushes past STACK_DEPTH go to a sink column and are not counted
    (the build keeps depth * (W - 1) + 1 <= STACK_DEPTH).  The first
    `fixed_steps` steps run without a host read, then one read per step
    until no ray walks.  Misses keep t = maxt.  The first walk of a
    scene uploads its BVH (scene.scene_bvh)."""
    bvh = scene_bvh(sd)
    n = o.shape[0]
    dev = o.device
    T = sd.tri_v0.shape[0]
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    inv_d = (1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d))[:, None, :]
    o3, d3 = o[:, None, :], d[:, None, :]
    lanes = torch.arange(LEAF_SIZE, dtype=torch.int64, device=dev)

    # the last column is the sink of dropped pushes; the root is pushed
    stack = torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = maxt.to(torch.float32).clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)

    def walking():
        alive = sp > 0
        return alive & (best_i < 0) if any_hit else alive

    steps = 0
    while steps < fixed_steps or bool(walking().any()):
        steps += 1
        active = walking()
        spm1 = torch.clamp_min(sp - 1, 0)
        entry = _take(stack, spm1)
        sp = torch.where(active, spm1, sp)
        is_leaf = active & (entry < 0)
        is_node = active & (entry >= 0)

        # inner node: test the W children, push the hits
        node = torch.where(is_node, entry, 0)
        child = bvh.child[node].to(torch.int64)
        count = bvh.count[node]
        box_hit, _ = _ray_box(bvh.bmin[node], bvh.bmax[node], o3, inv_d,
                              mint[:, None], best_t[:, None])
        box_hit = box_hit & (count >= 0) & is_node[:, None]
        enc = torch.where(count > 0, -(child * LEAF_ENC + count) - 1, child)
        hits = box_hit.to(torch.int64)
        pos = sp[:, None] + torch.cumsum(hits, dim=-1) - hits
        kept = box_hit & (pos < STACK_DEPTH)
        stack.scatter_(1, torch.where(kept, pos, STACK_DEPTH), enc)
        sp = sp + kept.sum(dim=-1)

        # leaf: test its triangles
        lv = -entry - 1
        start = torch.where(is_leaf, lv // LEAF_ENC, 0)
        lcount = torch.where(is_leaf, lv % LEAF_ENC, 0)
        tri_idx = start[:, None] + lanes[None, :]
        gi = torch.clamp_max(tri_idx, T - 1)
        hit, t, u, v = _moller_trumbore(
            sd.tri_v0[gi], sd.tri_e1[gi], sd.tri_e2[gi], o3, d3,
            mint[:, None], best_t[:, None])
        hit = hit & (lanes[None, :] < lcount[:, None]) & is_leaf[:, None]
        t = torch.where(hit, t, float("inf"))
        j = torch.argmin(t, dim=-1)
        tj = _take(t, j)
        better = tj < best_t
        best_i = torch.where(better, _take(tri_idx, j).to(torch.int32), best_i)
        best_u = torch.where(better, _take(u, j), best_u)
        best_v = torch.where(better, _take(v, j), best_v)
        best_t = torch.where(better, tj, best_t)
    return Hit(valid=best_i >= 0, t=best_t, tri=best_i, u=best_u, v=best_v)


def streamed(sd) -> bool:
    """Is the scene laid out for the streamed sweep (traverse.py:278)?
    The 16-row operand is the one fact that says so."""
    return sd.tri_packed.shape[0] == 16


def sweep_operand(sd) -> str:
    """The operand _sweep tests on this scene now: "mxu" (resident
    scenes with config.USE_MXU_SWEEP), else "bw" with
    config.USE_BW_SWEEP, else "mt"."""
    if config.USE_MXU_SWEEP and not streamed(sd):
        return "mxu"
    return "bw" if config.USE_BW_SWEEP else "mt"


#: SceneData -> {cull_t: its K5-cull gate boxes}, beside the scene data
_CULL_BOXES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cull_boxes(sd, cull_t: int):
    """sd's gate boxes of cull_t triangles for K5-cull: tri_sub_boxes at
    STREAM_G; another size is built (sweep.stream_sub_boxes) at the
    scene's first query with it, which a driver runs eagerly, and kept
    beside the scene data."""
    if cull_t == STREAM_G:
        return sd.tri_sub_boxes
    per = _CULL_BOXES.setdefault(sd, {})
    if cull_t not in per:
        per[cull_t] = stream_sub_boxes(sd.tri_packed, cull_t)
    return per[cull_t]


#: per card, while spans are on: [K5's gate tally, (2,) int64 on the
#: card that every streamed sweep's warps add to, and the two counts
#: already added to spans' counters]
_TALLY: dict = {}


def _card(device) -> torch.device:
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


def _gate_tally(device):
    """The tally K5 adds to on `device` while spans are on, else None.
    It is made at the first streamed sweep with spans on, which a driver
    runs eagerly; made in a capture, the memset would run at each replay,
    so a capture that finds none passes none."""
    if device.type != "cuda" or not spans.enabled():
        return None
    entry = _TALLY.get(_card(device))
    if entry is None:
        if torch.cuda.is_current_stream_capturing():
            return None
        entry = _TALLY[_card(device)] = [
            torch.zeros((2,), dtype=torch.int64, device=device), [0, 0]]
    return entry[0]


def count_gate_tally(device) -> None:
    """Add to spans' counters `sweeps.stream_groups` and
    `sweeps.stream_groups_culled` the sub-blocks that K5's warps on
    `device` tested, and those their gates skipped while a ray still
    searched, since the last call.  A replayed sweep adds to the card's
    tally by itself.  Reads the card: a driver calls it once an image
    inside its copy_out sync, after the image's copy, so the read waits
    for nothing."""
    if device.type != "cuda" or not spans.enabled():
        return
    entry = _TALLY.get(_card(device))
    if entry is None:
        return
    now = entry[0].tolist()
    spans.count("sweeps.stream_groups", now[0] - entry[1][0])
    spans.count("sweeps.stream_groups_culled", now[1] - entry[1][1])
    entry[1] = now


def _sweep(sd, rays, any_hit: bool):
    """(t, idx) dispatch as traverse.py:249-305 (`_sweep_any`), less the
    TPU's memory budgets: the operand lives in device memory.  The
    Baldwin-Weber rows when config.USE_BW_SWEEP, else the
    Moller-Trumbore soup, whose rounding matches the JAX package's CPU
    scan path.  A streamed sweep is gated by the scene's boxes."""
    keys, idx_bits = ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    op = sweep_operand(sd)
    use_bw = op == "bw"
    if streamed(sd):
        cull_t = config.STREAM_CULL_T
        spans.count("sweeps.streamed")
        tally = _gate_tally(rays.device)
        with spans.span("sweep.stream"):
            if not use_bw and cull_sub_blocks(cull_t) > 1:
                return stream_sweep_culled(sd.tri_packed, keys, idx_bits,
                                           rays, any_hit=any_hit,
                                           cull_t=cull_t,
                                           sub_boxes=cull_boxes(sd, cull_t),
                                           tally=tally)
            return stream_sweep(sd.tri_bw if use_bw else sd.tri_packed,
                                keys, idx_bits, rays, any_hit=any_hit,
                                use_bw=use_bw, sub_boxes=sd.tri_sub_boxes,
                                tally=tally)
    if op == "mxu":
        return resident_sweep_mxu(sd.tri_mxu, keys, idx_bits, rays,
                                  any_hit=any_hit)
    return resident_sweep(sd.tri_bw if use_bw else sd.tri_packed, keys,
                          idx_bits, rays, any_hit=any_hit)


def sweep_hit_epilogue(sd, rays, t, idx, n) -> Hit:
    """(t, idx) sweep results -> Hit with barycentrics.

    The sweep tracks only (t, idx); the winner's (u, v) come from one
    Moller-Trumbore test per ray against its row of tri_attr (v0|e1|e2
    in cols 19:28), clipped to [0, 1] with a 1e-30 det guard
    (traverse.py:394-419)."""
    t, idx = t[:n], idx[:n]
    aw = sd.tri_attr[torch.clamp_min(idx, 0).long()]
    v0w, e1w, e2w = aw[:, 19:22], aw[:, 22:25], aw[:, 25:28]
    ow = rays[0:3, :n].T
    dw = rays[3:6, :n].T
    pv = cross(dw, e2w)
    det = torch.sum(e1w * pv, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    tv = ow - v0w
    u = torch.clamp(torch.sum(tv * pv, dim=-1) * inv_det, 0.0, 1.0)
    qv = cross(tv, e1w)
    v = torch.clamp(torch.sum(dw * qv, dim=-1) * inv_det, 0.0, 1.0)
    miss = idx < 0
    u = torch.where(miss, 0.0, u)
    v = torch.where(miss, 0.0, v)
    return Hit(valid=idx >= 0, t=t, tri=idx, u=u, v=v)


def intersect(sd, o, d, mint, maxt) -> Hit:
    """Closest-hit query (Scene::rayIntersect, scene.h:75-85) on the
    backend config.resolve_accel names."""
    mode = config.resolve_accel()
    if mode == "scan":
        return intersect_brute(sd, o, d, mint, maxt)
    if mode == "bvh":
        return intersect_bvh(sd, o, d, mint, maxt)
    rays, n = pack_rays(o, d, mint, maxt)
    t, idx = _sweep(sd, rays, False)
    return sweep_hit_epilogue(sd, rays, t, idx, n)


def intersect_mixed(sd, oc, dc, mintc, maxtc, os_, ds_, mints, maxts,
                    raw: bool = False):
    """Closest hit for (oc, dc, mintc, maxtc) and any hit for (os_,
    ds_, mints, maxts) in one mixed sweep (K4), as traverse.py:308-368.

    Both sets are packed and concatenated; K1 and the key sort run once
    on all rays, and the ray tiles of the shadow set carry the any-hit
    flag.  Returns (Hit of the closest set, occluded bool of the shadow
    set); with raw=True, (t, idx, occ) with t and idx padded to the
    closest set's packed width and no barycentric epilogue (the merged
    wavefront step carries them to the next step).  config.USE_MXU_SWEEP
    is ignored, as the JAX package ignores it here.  A streamed scene,
    and the "scan" and "bvh" backends, take the two separate queries."""
    if config.resolve_accel() != "pallas" or streamed(sd):
        hit = intersect(sd, oc, dc, mintc, maxtc)
        occ = occluded(sd, os_, ds_, mints, maxts)
        if raw:
            return (torch.where(hit.valid, hit.t, float("inf")),
                    torch.where(hit.valid, hit.tri, -1), occ)
        return hit, occ
    rays_c, n_c = pack_rays(oc, dc, mintc, maxtc)
    rays_s, n_s = pack_rays(os_, ds_, mints, maxts)
    rays = torch.cat([rays_c, rays_s], dim=1)
    n_rt_c = rays_c.shape[1] // TILE_N
    tile_ah = (torch.arange(rays.shape[1] // TILE_N, device=rays.device)
               >= n_rt_c).to(torch.int32)
    keys, idx_bits = ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    op = sd.tri_bw if config.USE_BW_SWEEP else sd.tri_packed
    t, idx = resident_sweep_mixed(op, keys, idx_bits, rays, tile_ah)
    nc = rays_c.shape[1]
    occ = (idx[nc:] >= 0)[:n_s]
    if raw:
        return t[:nc], idx[:nc], occ
    return sweep_hit_epilogue(sd, rays_c, t[:nc], idx[:nc], n_c), occ


def shadow_order(sd, rays) -> torch.Tensor:
    """Permutation sorting packed rays by their own candidate slabs:
    K3 keys on the uncoarsened bounds, lexicographic in (key1, key2),
    ties by lane (traverse.py:371-391).  Both words are non-negative
    and < 2^30, so one int64 key sorts them."""
    k1, k2 = lane_keys(sd.tri_tile_bounds, rays)
    return torch.argsort((k1.to(torch.int64) << 32) | k2.to(torch.int64),
                         stable=True)


def occluded(sd, o, d, mint, maxt) -> torch.Tensor:
    """Shadow-ray query (Scene::rayIntersect shadowRay=true,
    scene.h:87-97): any hit in [mint, maxt].

    A streamed scene sweeps the rays in shadow_order, as
    traverse.py:473-477 does: shadow rays arrive in the bounce rays'
    order, which scatters their candidate slabs over each ray tile, and
    a streamed sweep pays for every slab a tile visits.  The answer does
    not depend on the order.  The "scan" and "bvh" backends answer by
    their own walks."""
    mode = config.resolve_accel()
    if mode == "scan":
        return intersect_brute(sd, o, d, mint, maxt).valid
    if mode == "bvh":
        return intersect_bvh(sd, o, d, mint, maxt, any_hit=True).valid
    rays, n = pack_rays(o, d, mint, maxt)
    if not streamed(sd):
        _, idx = _sweep(sd, rays, True)
        return idx[:n] >= 0
    with spans.span("step.shadow_sort"):
        perm = shadow_order(sd, rays)
        rays = rays[:, perm].contiguous()
    _, idx = _sweep(sd, rays, True)
    hit = torch.empty_like(idx, dtype=torch.bool)
    hit[perm] = idx >= 0
    return hit[:n]
