"""Wavefront ray-scene intersection.

Port of the resident-sweep path of `nori_tpu/accel/traverse.py`:
`intersect` (closest hit) and `occluded` (any hit) pack the rays, build
the per-ray-tile candidate keys (K1) and run the resident sweep (K2).
Triangle test semantics match Mesh::rayIntersect (src/mesh.cpp:51-88):
|det| > 1e-8, u in [0,1], v >= 0, u+v <= 1, t in [mint, maxt].

use_bw selects the operand: the Baldwin-Weber rows (the JAX package's
default, config.USE_BW_SWEEP) or the Moller-Trumbore soup, whose
rounding matches the JAX package's CPU scan path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nori_tpu_torch.accel.sweep import (
    pack_rays, ray_tile_entry_keys, resident_sweep)
from nori_tpu_torch.core.vecmath import cross


class Hit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor      # (N,)
    tri: torch.Tensor    # (N,) int32 (-1 where !valid)
    u: torch.Tensor      # (N,)
    v: torch.Tensor      # (N,)


def _sweep(sd, rays, any_hit: bool, use_bw: bool):
    if sd.tri_packed.shape[0] != 9:
        raise NotImplementedError(
            "streamed-scale scenes (9*T*4 bytes over 8 MB) need the "
            "streamed sweep (kernel K5), not yet ported to nori_tpu_torch")
    keys, idx_bits = ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    op = sd.tri_bw if use_bw else sd.tri_packed
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


def intersect(sd, o, d, mint, maxt, use_bw: bool = True) -> Hit:
    """Closest-hit query (Scene::rayIntersect, scene.h:75-85)."""
    rays, n = pack_rays(o, d, mint, maxt)
    t, idx = _sweep(sd, rays, False, use_bw)
    return sweep_hit_epilogue(sd, rays, t, idx, n)


def occluded(sd, o, d, mint, maxt, use_bw: bool = True) -> torch.Tensor:
    """Shadow-ray query (Scene::rayIntersect shadowRay=true,
    scene.h:87-97): any hit in [mint, maxt]."""
    rays, n = pack_rays(o, d, mint, maxt)
    _, idx = _sweep(sd, rays, True, use_bw)
    return idx[:n] >= 0
