"""Kernel-level accounting for the sweep intersection.

Port of `nori_tpu/profiling.py`.  Beside the wall-clock throughput of
a render, the sweep's actual work: candidate ray-triangle pairs (exact,
from the per-lane slab tests and from kernel K1's per-ray-tile
entries), the achieved pair-test rate, and the arithmetic rate the
swept operand implies.  The port's bench reports them beside its
throughput numbers.
"""

from __future__ import annotations

import time

import torch

from nori_tpu_torch.accel.sweep import (
    FINE_T, STREAM_T, TILE_N, _safe_inv, _slab, entry_min, pack_rays)
from nori_tpu_torch.accel.traverse import (
    intersect, streamed, sweep_operand)
from nori_tpu_torch.integrators.path import MIS
from nori_tpu_torch.device import resolve_device
from nori_tpu_torch.wavefront import make_wavefront_stepper

#: operations per tested ray-triangle pair of each operand (chip_smoke.py
#: bounds the sweeps by the same table): Baldwin-Weber and
#: Moller-Trumbore (the JAX package's counts), and the matmul form's
#: four 10-term sums, 76, plus its epilogue's 13
PAIR_OPS = {"bw": 40, "mt": 56, "mxu": 89}
#: rays per chunk of the per-lane slab test: a (chunk, tiles, 3) float
#: temporary takes 20 MB at 404 tiles (0.6 GB unchunked at 131,072 rays)
CAND_CHUNK = 4096


def candidate_stats(scene_data, o, d, mint, maxt) -> dict:
    """Exact candidate-tile statistics for a ray population.

    Returns the per-LANE candidate pairs per live ray (what a sweep with
    perfect per-lane scheduling would test) and the per-ray-TILE union
    pairs per live ray (what the 256-lane sweep tests, before its
    skyline exit), the union from kernel K1 (its plain version on the
    CPU).  Pairs count the triangles of a tile: FINE_T on resident
    scenes, STREAM_T on streamed ones.
    """
    rays, n = pack_rays(o, d, mint, maxt)
    tb = scene_data.tri_tile_bounds
    tile_t = STREAM_T if streamed(scene_data) else FINE_T
    live = rays[6] <= rays[7]
    lane_tiles = 0
    for a in range(0, rays.shape[1], CAND_CHUNK):
        r = rays[:, a:a + CAND_CHUNK]
        cand, _ = _slab(tb[:, 0:3], tb[:, 3:6], r[0:3].T[:, None],
                        _safe_inv(r[3:6].T)[:, None], r[6][:, None],
                        r[7][:, None])
        lane_tiles += int((cand & live[a:a + CAND_CHUNK, None]).sum())
    union_tiles = int(torch.isfinite(entry_min(tb, rays)).sum())
    n_live = max(int(live.sum()), 1)
    return {
        "rays": int(n),
        "lane_pairs_per_ray": lane_tiles * tile_t / n_live,
        "union_pairs_per_ray": union_tiles * tile_t * TILE_N / n_live,
        "fine_tiles": int(tb.shape[0]),
    }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_intersect(scene_data, o, d, mint, maxt, repeats: int = 20) -> float:
    """Seconds per closest-hit query (traverse.intersect) on a ray set:
    host clock around `repeats` queries that end in a synchronise,
    after one warm-up query."""
    intersect(scene_data, o, d, mint, maxt)
    _sync(o.device)
    t0 = time.time()
    for _ in range(repeats):
        intersect(scene_data, o, d, mint, maxt)
    _sync(o.device)
    return (time.time() - t0) / repeats


def kernel_report(scene, n_rays: int = 131072, seed: int = 0,
                  bounce_steps: int = 8, device=None) -> dict:
    """Sweep-kernel report on a realistic mid-render ray distribution:
    run `bounce_steps` wavefront steps of an n_rays-lane pool on
    `device` (default: the current CUDA device; device.resolve_device),
    then time the closest-hit sweep on the pool's rays and relate it to
    the exact candidate-pair counts.  gflops_est counts PAIR_OPS of the
    swept operand per union pair."""
    device = resolve_device(device)
    sd = scene.compile(device)
    scene.integrator.preprocess(scene)
    mode = getattr(scene.integrator, "mode", MIS)
    chunk = 64 * n_rays
    init, step, _, _ = make_wavefront_stepper(scene, mode, n_rays, chunk,
                                              device=device)
    carry = init(seed, 0, chunk)
    for _ in range(bounce_steps):
        carry = step(sd, carry, seed)
    st = carry[0]
    o, d, mint, maxt = st["o"], st["d"], st["mint"], st["maxt"]

    stats = candidate_stats(sd, o, d, mint, maxt)
    dt = time_intersect(sd, o, d, mint, maxt)
    pairs = stats["union_pairs_per_ray"] * stats["rays"]
    stats.update({
        "sweep_ms": dt * 1e3,
        "sweep_mrays_per_sec": stats["rays"] / dt / 1e6,
        "pair_tests_per_sec": pairs / dt / 1e9,  # G pairs/s
        "gflops_est": pairs * PAIR_OPS[sweep_operand(sd)] / dt / 1e9,
    })
    return stats
