#!/usr/bin/env python3
"""Visits per ray tile of the resident sweeps on one CUDA card.

    python3 scripts/resident_visits.py [ROOT]

With the kernels of the checkout at ROOT (default: this one), on the
living room (chip_smoke FULL) after two wavefront steps, at
131,072 and 524,288 lanes: for K2 (BW and MT closest on the camera and
bounce rays, BW any-hit on their shadow rays), K4 on both sets and
K2-mxu, the launch time (CUDA events, chip_smoke.time_ms) and the
distribution of the kernel's visit counts over ray tiles (mean, p50,
p99, max, the ray tiles above 4x the mean, the 24 largest), the
candidate keys per row, and for caps c of a first pass the share of
all visits that lie beyond c visits of their row, one line per query.
Needs of ROOT's chip_smoke only what every version of it has (FULL,
CHECK_LANES, wavefront_rays, time_ms, build_kernels, card_line), so it
runs on older checkouts too.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
sys.path.insert(0, ROOT)

CAPS = (4, 8, 16, 24, 32, 48, 64, 96)


def visit_stats(visits) -> dict:
    """As chip_smoke.visit_stats: mean, p50, p99, max, the ray tiles
    above 4x the mean."""
    v = visits.double().cpu()
    mean = float(v.mean())
    return dict(mean=mean, p50=float(v.quantile(0.5)),
                p99=float(v.quantile(0.99)), max=int(v.max()),
                over_4x_mean=int((v > 4 * mean).sum()), ray_tiles=v.numel())


def beyond(visits) -> dict:
    """{cap: (ray tiles over it, share of all visits past it)}."""
    v = visits.long().cpu()
    tot = max(int(v.sum()), 1)
    return {c: (int((v > c).sum()), float((v - c).clamp_min(0).sum()) / tot)
            for c in CAPS}


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.scenes_builtin import living_room

    dev = torch.device("cuda:0")
    print(cs.card_line(), ROOT)
    cs.build_kernels()
    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    for lanes in (cs.CHECK_LANES, cfg["n_lanes"]):
        rays, shadow = cs.wavefront_rays(scene, sd, dev, lanes)
        both = torch.cat([rays, shadow], dim=1).contiguous()
        flags = (torch.arange(both.shape[1] // 256, device=dev)
                 >= rays.shape[1] // 256).to(torch.int32)
        kc = sweep.ray_tile_entry_keys(tb, rays)
        ks = sweep.ray_tile_entry_keys(tb, shadow)
        kb = sweep.ray_tile_entry_keys(tb, both)
        queries = {
            "K2 bw closest": (kc, rays, lambda v=None: sweep.resident_sweep(
                sd.tri_bw, *kc, rays, False, visits=v)),
            "K2 mt closest": (kc, rays, lambda v=None: sweep.resident_sweep(
                sd.tri_packed, *kc, rays, False, visits=v)),
            "K2 bw any-hit": (ks, shadow, lambda v=None: sweep.resident_sweep(
                sd.tri_bw, *ks, shadow, True, visits=v)),
            "K4": (kb, both, lambda v=None: sweep.resident_sweep_mixed(
                sd.tri_bw, *kb, both, flags, visits=v)),
            "K2-mxu": (kc, rays, lambda v=None: sweep.resident_sweep_mxu(
                sd.tri_mxu, *kc, rays, visits=v)),
        }
        for label, ((keys, bits), r, call) in queries.items():
            cand = ((keys & ~((1 << bits) - 1)) < 0x7F800000).sum(1)
            visits = torch.zeros(r.shape[1] // 256, dtype=torch.int32,
                                 device=dev)
            call(visits)
            stats = visit_stats(visits)
            row = dict(
                lanes=lanes, query=label, ms=cs.time_ms(call), visits=stats,
                beyond=beyond(visits),
                candidates_mean=float(cand.double().mean()),
                candidates_max=int(cand.max()),
                largest=sorted(visits.cpu().tolist())[-24:])
            print(json.dumps(row), flush=True)
        del rays, shadow, both
    return 0


if __name__ == "__main__":
    sys.exit(main())
