"""Wavefront ray-scene intersection.

Port of the sweep path of `nori_tpu/accel/traverse.py`: `intersect`
(closest hit) and `occluded` (any hit) pack the rays, build the
per-ray-tile candidate keys (K1) and run the resident sweep (K2, or
K2-mxu on the matmul-form operand with config.USE_MXU_SWEEP) or, for
streamed-scale scenes (16-row operands, STREAM_T-triangle slab bounds,
as `Scene.compile_arrays` lays them out), the streamed sweep (K5, or
K5-cull with config.STREAM_CULL_T on the Moller-Trumbore operand).  A
streamed scene's shadow query first sorts its rays by their own
candidate slabs (K3).  `intersect_mixed` runs both queries in one
mixed launch (K4) for the wavefront's merged step.  The switches in
`nori_tpu_torch.config` are read at every query.  Triangle test
semantics match
Mesh::rayIntersect (src/mesh.cpp:51-88): |det| > 1e-8, u in [0,1],
v >= 0, u+v <= 1, t in [mint, maxt].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nori_tpu_torch import config
from nori_tpu_torch.accel.sweep import (
    TILE_N, cull_sub_blocks, lane_keys, pack_rays, ray_tile_entry_keys,
    resident_sweep, resident_sweep_mixed, resident_sweep_mxu, stream_sweep,
    stream_sweep_culled)
from nori_tpu_torch.core.vecmath import cross

class Hit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor      # (N,)
    tri: torch.Tensor    # (N,) int32 (-1 where !valid)
    u: torch.Tensor      # (N,)
    v: torch.Tensor      # (N,)


def streamed(sd) -> bool:
    """Is the scene laid out for the streamed sweep (traverse.py:278)?
    The 16-row operand is the one fact that says so."""
    return sd.tri_packed.shape[0] == 16


def _sweep(sd, rays, any_hit: bool):
    """(t, idx) dispatch as traverse.py:249-305 (`_sweep_any`), less the
    TPU's memory budgets: the operand lives in device memory.  The
    Baldwin-Weber rows when config.USE_BW_SWEEP, else the
    Moller-Trumbore soup, whose rounding matches the JAX package's CPU
    scan path."""
    keys, idx_bits = ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    use_bw = config.USE_BW_SWEEP
    if streamed(sd):
        cull_t = config.STREAM_CULL_T
        if not use_bw and cull_sub_blocks(cull_t) > 1:
            return stream_sweep_culled(sd.tri_packed, keys, idx_bits, rays,
                                       any_hit=any_hit, cull_t=cull_t)
        return stream_sweep(sd.tri_bw if use_bw else sd.tri_packed, keys,
                            idx_bits, rays, any_hit=any_hit, use_bw=use_bw)
    if config.USE_MXU_SWEEP:
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
    """Closest-hit query (Scene::rayIntersect, scene.h:75-85)."""
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
    is ignored, as the JAX package ignores it here.  A streamed scene
    takes the two separate queries."""
    if streamed(sd):
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
    not depend on the order."""
    rays, n = pack_rays(o, d, mint, maxt)
    if not streamed(sd):
        _, idx = _sweep(sd, rays, True)
        return idx[:n] >= 0
    perm = shadow_order(sd, rays)
    _, idx = _sweep(sd, rays[:, perm].contiguous(), True)
    hit = torch.empty_like(idx, dtype=torch.bool)
    hit[perm] = idx >= 0
    return hit[:n]
