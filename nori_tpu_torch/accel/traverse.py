"""Wavefront ray-scene intersection.

Port of the sweep path of `nori_tpu/accel/traverse.py`: `intersect`
(closest hit) and `occluded` (any hit) pack the rays, build the
per-ray-tile candidate keys (K1) and run the resident sweep (K2) or,
for streamed-scale scenes (16-row operands, STREAM_T-triangle slab
bounds, as `Scene.compile_arrays` lays them out), the streamed sweep
(K5).  A streamed scene's shadow query first sorts its rays by their
own candidate slabs (K3).  Triangle test semantics match
Mesh::rayIntersect (src/mesh.cpp:51-88): |det| > 1e-8, u in [0,1],
v >= 0, u+v <= 1, t in [mint, maxt].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nori_tpu_torch.accel.sweep import (
    lane_keys, pack_rays, ray_tile_entry_keys, resident_sweep, stream_sweep)
from nori_tpu_torch.core.vecmath import cross

#: sweep the Baldwin-Weber rows (the JAX package's default,
#: config.USE_BW_SWEEP); False sweeps the Moller-Trumbore soup, whose
#: rounding matches the JAX package's CPU scan path
USE_BW = True

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
    keys, idx_bits = ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    op = sd.tri_bw if USE_BW else sd.tri_packed
    if streamed(sd):
        return stream_sweep(op, keys, idx_bits, rays, any_hit=any_hit,
                            use_bw=USE_BW)
    return resident_sweep(op, keys, idx_bits, rays, any_hit=any_hit)


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
