#!/usr/bin/env python3
"""Smoke test of nori_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels (K1 entry_min, K2 resident_sweep, K2-mxu
resident_sweep_mxu, K3 lane_keys, K4 resident_sweep_mixed, K5
stream_sweep, K5-cull stream_sweep_culled, K6 mt_sweep) from
nori_tpu_torch/csrc/ and drives the paths of the port, each through
its kernels:

* the persistent wavefront on the living room (51,712 triangles, K1,
  K2, K3): each kernel against its plain PyTorch version on the card at
  the path's shapes, a small render on the card against the CPU, and
  the full 1280x720, 32 spp, 524,288-lane render through
  `render_to_files`.  K1 and K3 are held bit for bit on 131,072 check
  rays and on what a steady 524,288-lane step hands them
  (scripts/keys_inputs.py), each with the ray-box tests its gate on
  groups of consecutive boxes does and needs beside rays x boxes.  K2 (BW and MT closest, BW any-hit) must give the
  plain version's hits, triangles and t bits; each query prints its
  visits per ray tile over both of K2's passes (mean, p50, p99, max,
  the ray tiles above 4x the mean) and the work items its first pass
  left to the tail pass, and so do K4 and K2-mxu;
* the merged wavefront step (config.MERGED_SWEEP, K4): K4 against its
  plain version and against the two K2 launches it replaces, then the
  full render merged, alternated with the two-launch render, whose
  image it must equal bit for bit, with K4 on every step and K2 once;
* the matmul-form sweep (config.USE_MXU_SWEEP, K2-mxu): the kernel
  against its plain version, a small render card vs CPU, the full
  render against the BW render's mean radiance and rays;
* the 2-D sweep (K6, which only this script calls in the port):
  closest and any-hit on the wavefront's rays, against its plain
  version (t, u and v equal, triangles except at exact ties in t), each
  query with its visits per ray tile in quarter tiles and the work items
  its plan left to the persistent blocks;
* the batch driver on the ajax composition (the 541,696-triangle
  procedural stand-in for the pa2/pa5 ajax scan, streamed layout, K1,
  K3, K5): the kernels against their plain versions on the slab
  bounds and 32,768 camera and shadow rays (K1 and K3 also on what one
  whole whitted batch hands them), K5 any-hit also on one
  whole 131,072-sample whitted batch's shadow rays in the order
  `traverse.occluded` sorts them (and unsorted), each with the bound of
  the slabs it needed; K5 must give the plain version's hits,
  triangles and t bits, and each query prints its visits per ray tile in
  quarter slabs (mean, p50, p99, max, the ray tiles above 4x the mean)
  and its work items; normals/whitted/path_mis
  renders on the card against the CPU, and the full ajax_normals
  (768x768, 4 spp) and ajax_rough (768x768, 16 spp, whitted) renders
  through `render_to_files`, which must launch K5 and never K2;
* sub-slab culling (config.STREAM_CULL_T = 128 on the Moller-Trumbore
  operand, K5-cull): the kernel against its plain version and against
  K5 uncut, with its visits in sub-blocks and its work items, then
  ajax_normals culled against the uncut render;
* checkpoint/resume (K1, K2, K3): the full living-room render in four
  chunks, uncut, then cut after two chunks with a checkpoint, a preview
  PNG and an on_chunk callback, then resumed to the uncut image's SHA-1
  and ray count;
* the sharded drivers (nori_tpu_torch.parallel): the full living-room
  render through render_sharded_wavefront at 524,288 lanes and the
  checkpointed render's chunk per rank, at one nccl rank in this process
  and at two gloo ranks spawned on the one card (NCCL refuses two ranks
  on a card), each to the uncut checkpointed image's SHA-1 and rays,
  with K1, K2 and K3 on every rank; then ajax_normals through
  render_sharded at the same rank counts against the single-device
  batch driver (equal rays, the same image bits), with K5 and never K2
  on every rank.  Each rank reads its own launch counts;
* the multi-card entry point's dry run (nori_tpu_torch.scripts.multicard,
  the counterpart of __graft_entry__.dryrun_multichip) at MULTICARD_RANKS
  gloo ranks spawned on the one card: a sharded batch pass and a small
  sharded wavefront with finite results, and the 96x54 living room
  twice, each rank launching K1 and K2, to the rays and image bits
  of render_wavefront on the card, the repeat bit-identical;
* the sweep report (nori_tpu_torch.profiling.kernel_report) on the full
  living room's 131,072-lane pool after 8 wavefront steps: candidate
  pairs per ray, the closest-hit sweep's time and rates (K1, K2, K3);
* the statistical harness through the CLI's test root: the microfacet
  t-test of ttest-microfacet.xml, furnace t-tests of path_mats,
  path_ems, path_mis and whitted (and the path_mis furnace held to a
  wrong mean, which must fail), chi2test on diffuse and three microfacet
  roughnesses, warptest on every warp; then the port's runner of the
  reference's statistical fixtures (nori_tpu_torch.scripts.ref_gates)
  at --scale 16 over a temporary root holding the same microfacet
  t-test, furnace and chi^2 suite under names of their own, each of
  which must pass every test it holds, with K1 and K2 launched by the
  furnace scenes;
* the scan and BVH backends (config.accel_mode): closest and any-hit
  queries on the living room's check rays under scan, bvh and the
  sweeps, each timed, then a small render under bvh against the sweeps';
* the path-graph pipeline (nori_tpu_torch.pathgraph, K1 and K2): the
  dump of tests/test_pathgraph.py's fixture (Cornell box 32x32, depth 5)
  and `pg.run` in all five modes on the card against the same on the
  CPU (the dumps' integer fields, the paths whose point count differs
  printed; the seven images of each mode under the image gate of
  tests/test_torch_render.py); then one protocol-scale run (PG_PROTOCOL:
  the living room at 1280x720, depth 8, k = 16, 3 iterations) in mode
  opt and mode knn, with the seconds of every stage and the peak device
  memory, whose outputs must be finite, whose full image and the dump's
  own PT image must have a mean in MEAN_RANGE, and which must launch K1
  and K2 and never K5;
* the measurement and evaluation entry points: `python bench_torch.py`
  in a subprocess with a BENCH_BUDGET_S budget (its last line a complete
  record with the living_room and ajax_rough rows, each row's two image
  SHA-1s equal and its rays > 0, K1, K2 and K3 launched by the living
  room and K1, K3 and K5 by ajax_rough); the matched-RMSE gate
  (nori_tpu_torch.scripts.rmse_gate) with link 3 at GATE_SPP, whose
  links 1 (against the JAX package's CPU render
  scratch/rmse_gate/lr_cpu_ref.npz) and 2 must pass; the ten rows of
  scratch/living_room_1024spp_rows.npz (the JAX package's CPU render of
  the rows the 1024-spp reference misplaced, tools/reference_rows.py)
  rendered on the card over the same row ranges through the checkpoint
  resume, held to the npz by the exact gate and ROWS_MAX_ABS (K1, K2,
  K3); and the path-graph
  evaluation (nori_tpu_torch.scripts.pathgraph_eval, PG_EVAL) run twice
  in one directory, the second call resuming every run, the reference
  and the curve to the same JSON with no kernel launched.

Each path resets every kernel's launch count just before it runs and
reads the counts just after.  Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing any result.
Every phase prints its time.

A sweep's bound counts the pair tests its inputs and its plain answer
show to be needed (keys_needed, mt_needed: the tiles, slabs or
sub-blocks within each ray tile's final skyline), the same whatever the
kernel's schedule; what the kernel tested (its `visits`) is printed
beside it.

The last three lines of standard output are one JSON object with the
kernels' checks, times and bounds, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

builds the kernels and prints only a torch.profiler breakdown of one
131,072-sample whitted batch of the ajax_rough render, on the batch
driver's graphed pass.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# outside a checkout of the repo this import fails before any output
from nori_tpu_torch.bench import AJAX_SIZE, ajax_scene
from nori_tpu_torch.profiling import PAIR_OPS

#: full-size render (the workload bench.py and BASELINE.md head with)
FULL = dict(width=1280, height=720, spp=32, detail=5, n_lanes=524288)
#: parity render, port on the card vs port on the CPU
PARITY = dict(width=64, height=64, spp=2, detail=3, n_lanes=8192)
#: rays for the kernel checks (camera and bounce rays of the wavefront)
CHECK_LANES = 131072
#: full render's mean radiance must lie here: the port's CPU render of
#: the same scene at 160x90, 8 spp, detail 3 has mean 0.2690 and
#: 0.2703 (seeds 1 and 2); the band allows for resolution, detail and
#: noise
MEAN_RANGE = (0.22, 0.32)
SEED = 0

#: full renders of the ajax composition (nori_tpu_torch.bench.ajax_scene):
#: (integrator, spp, mean-radiance band).  The bands come from the
#: port's CPU renders of the same composition at 48x48 with
#: the stand-in at n_lat=128, n_lon=132: normals 0.4920 and 0.4918,
#: whitted 0.0618 and 0.0628 (seeds 1 and 2; 0.4944 and 0.0623/0.0640
#: at 64x66); they allow for resolution, tessellation and noise
AJAX_FULL = {
    "ajax_normals": ("normals", 4, (0.44, 0.54)),
    "ajax_rough": ("whitted", 16, (0.050, 0.076)),
}
#: the stand-in at its defaults (512 x 530): 541,660 triangles padded to
#: 1,058 slabs of 512
AJAX_TRIS, AJAX_SLABS = 541696, 1058
#: rays of the ajax kernel checks
AJAX_CHECK_LANES = 32768
#: batch of ajax_rough (the middle of the image, on the bust) whose
#: 131,072 shadow rays the sorted any-hit check sweeps
AJAX_SORTED_BATCH = 36
#: parity renders on the ajax scene, port on the card vs the CPU
AJAX_PARITY = (("normals", 32, 2, "render"), ("whitted", 32, 4, "render"),
               ("path_mis", 16, 2, "wavefront"))
#: parity render of the matmul-form sweep, port on the card vs the CPU
MXU_PARITY = dict(width=16, height=16, spp=2, detail=3, n_lanes=4096)
#: sub-slab culling granularity of the K5-cull path
CULL_T = 128
#: the checkpointed full render runs in this many chunks
CKPT_CHUNKS = 4
#: rank counts of the sharded phases: one nccl rank in this process, two
#: gloo ranks spawned on the one card (NCCL refuses two ranks on a card)
SHARDED_RANKS = (1, 2)
#: ranks of the multi-card dry run: gloo ranks spawned on the one card
MULTICARD_RANKS = 2
#: ttest-microfacet.xml's angles and reference means (tests/test_bsdf.py)
TTEST_ANGLES = (0, 45, 60, 80, 85)
TTEST_REFERENCES = (0.207067, 0.215733, 0.247884, 0.430936, 0.519016)
#: furnace t-tests: (integrator, mean radiance); albedo 0.5, radiance 1
FURNACE = (("path_mats", 2.0), ("path_ems", 2.0), ("path_mis", 2.0),
           ("whitted", 1.5))
#: microfacet roughnesses of the chi^2 suite (beside a diffuse BSDF)
CHI2_ALPHAS = (0.1, 0.5, 1.0)
#: the ref-gates runner phase's sample-count divisor
REF_GATES_SCALE = 16
#: the reference-rows phase's loose bound on any pixel: at 1024 spp the
#: full-size link's largest difference outside the misplaced rows is
#: 0.0508, and the misplaced samples moved pixels by up to 4.85
#: (RMSE_GATE_torch.json, NVIDIA H100 80GB HBM3, 700.00 W)
ROWS_MAX_ABS = 0.5

#: the path-graph fixture of tests/test_pathgraph.py, card vs CPU
PG_PARITY = dict(width=32, height=32, sphere_subdiv=1, max_depth=5,
                 batch=1024, k=8, iterations=1)
PG_MODES = ("opt", "n", "t", "l", "knn")
#: one run of the path-graph protocol (PGPROTOCOL_r05.json, 18 such
#: 1-spp runs merged; scripts/pathgraph_eval.py's defaults): the living
#: room at 1280x720, detail 3, depth 8, trace_dump's default batch, then
#: k = 16 and 3 iterations
PG_PROTOCOL = dict(width=1280, height=720, detail=3, max_depth=8, k=16,
                   iterations=3)
#: the bench phase: bench_torch.py's time budget, and the kernels each
#: named row must launch
BENCH_BUDGET_S = 240
BENCH_KERNELS = {"living_room": ("entry_min", "resident_sweep", "lane_keys"),
                 "ajax_rough": ("entry_min", "lane_keys", "stream_sweep")}
#: the reduced matched-RMSE gate: link 3's spp
GATE_SPP = 64
#: the path-graph evaluation phase: the living room at 256x256, two runs
PG_EVAL = ["--scene", "living_room", "--res", "256", "--detail", "3",
           "--runs", "2", "--k", "16", "--iters", "3", "--ref-spp", "64"]
#: the H100 SXM's published peaks (NVIDIA's data sheet): fp32 outside
#: the tensor cores, and device memory
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: operations per ray-box slab test with its fold (12 to reach the six
#: planes, 6 min/max per axis, 4 for entry and exit, 3 compares, 2 to
#: fold)
SLAB_OPS = 27
#: the port's kernels: wrapper name -> (row label, source, the TPU
#: kernel it replaces)
KERNELS = {
    "entry_min": ("K1", "nori_tpu_torch/csrc/entry_min.cu",
                  "nori_tpu/accel/pallas_mt.py:896"),
    "resident_sweep": ("K2", "nori_tpu_torch/csrc/resident_sweep.cu",
                       "nori_tpu/accel/pallas_mt.py:291"),
    "resident_sweep_mxu": ("K2-mxu", "nori_tpu_torch/csrc/resident_sweep.cu",
                           "nori_tpu/accel/pallas_mt.py:392"),
    "lane_keys": ("K3", "nori_tpu_torch/csrc/lane_keys.cu",
                  "nori_tpu/accel/pallas_mt.py:982"),
    "resident_sweep_mixed": ("K4", "nori_tpu_torch/csrc/resident_sweep.cu",
                             "nori_tpu/accel/pallas_mt.py:353"),
    "stream_sweep": ("K5", "nori_tpu_torch/csrc/stream_sweep.cu",
                     "nori_tpu/accel/pallas_mt.py:526"),
    "stream_sweep_culled": ("K5-cull", "nori_tpu_torch/csrc/stream_sweep.cu",
                            "nori_tpu/accel/pallas_mt.py:619"),
    "mt_sweep": ("K6", "nori_tpu_torch/csrc/mt_sweep.cu",
                 "nori_tpu/accel/pallas_mt.py:77"),
}


def log(msg: str):
    print(msg, flush=True)


def wrappers() -> dict:
    from nori_tpu_torch.accel import sweep

    return {name: getattr(sweep, name) for name in KERNELS}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


@contextlib.contextmanager
def switches(**values):
    """Set nori_tpu_torch.config switches for a block, then restore."""
    from nori_tpu_torch import config

    old = {k: getattr(config, k) for k in values}
    for k, v in values.items():
        setattr(config, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(config, k, v)


def record(name: str, ms: float, plain_ms: float, max_abs_err: float,
           ops: float, nbytes: float, **extra) -> dict:
    """A kernel's JSON record.  bound_ms is the larger of ops over the
    fp32 peak and bytes over the memory rate, for the inputs it was
    timed on; library_ms is null: no single PyTorch call computes any of
    these functions."""
    label, source, replaces = KERNELS[name]
    return dict(name=name, kernel=label, route="cuda", source=source,
                replaces=replaces, launches=0, max_abs_err=max_abs_err,
                ms=ms, plain_ms=plain_ms, **bound(ops, nbytes),
                library_ms=None, **extra)


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of ops over the
    fp32 peak and bytes over the memory rate, and which it is."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


def sweep_bytes(read_rows: int, T: int, n_rays: int, key_cols: int) -> float:
    """Bytes a sweep must move: its operand's read rows, the packed
    rays, the key rows (one int32 per ray tile and tile), t and idx."""
    return 4.0 * (read_rows * T + 8 * n_rays + (n_rays // 256) * key_cols
                  + 2 * n_rays)


def sweep_visits(call, rays):
    """The kernel's visit count per ray tile on these rays: (n_rt,)
    int32, the triangle groups each ray tile tested."""
    import torch

    visits = torch.zeros(rays.shape[1] // 256, dtype=torch.int32,
                         device=rays.device)
    call(visits)
    return visits


def visit_stats(visits) -> dict:
    """Distribution of visit counts over ray tiles (idle tiles included):
    mean, p50, p99, max, and the ray tiles above 4x the mean."""
    v = visits.double().cpu()
    mean = float(v.mean())
    return dict(mean=mean, p50=float(v.quantile(0.5)),
                p99=float(v.quantile(0.99)), max=int(v.max()),
                over_4x_mean=int((v > 4 * mean).sum()), ray_tiles=v.numel())


def fmt_stats(s: dict) -> str:
    return (f"visits per ray tile: mean {s['mean']:.2f}, p50 {s['p50']:.0f}, "
            f"p99 {s['p99']:.1f}, max {s['max']}, {s['over_4x_mean']} of "
            f"{s['ray_tiles']} ray tiles above 4x the mean")


def resident_run(call, rays, n_keys: int):
    """One run of a resident sweep (K2, K2-mxu, K4), given as
    call(visits, workspace): its visits per ray tile, summed over both
    passes, and the work items its first pass left to the tail pass."""
    from nori_tpu_torch.accel import sweep

    ws = sweep.resident_workspace(rays.shape[1], n_keys, rays.device)
    visits = sweep_visits(lambda v: call(v, ws), rays)
    return visits, sweep.tail_items(ws, rays.shape[1], n_keys)


def stream_run(call, rays):
    """One run of a streamed or 2-D sweep (K5, K5-cull, K6), given as
    call(visits, workspace): its visits per ray tile (triangle groups
    tested, over all its work items) and what its plan left to the
    persistent blocks (ray tiles with work, most chunks of one, work
    items)."""
    from nori_tpu_torch.accel import sweep

    ws = sweep.stream_workspace(rays.shape[1], rays.device)
    visits = sweep_visits(lambda v: call(v, ws), rays)
    return visits, sweep.stream_work(ws, rays.shape[1])


def n_rt(n: int) -> int:
    """Ray tiles of n rays."""
    return n // 256


def gate_tally(call) -> dict:
    """One more run of a streamed sweep, given as call(tally=...): the
    sub-blocks of STREAM_G triangles its warps tested and those their
    gates skipped while one of their rays searched, and the skipped
    share."""
    import torch

    tally = torch.zeros((2,), dtype=torch.int64, device="cuda")
    call(tally=tally)
    tested, culled = tally.tolist()
    return dict(tested=tested, culled=culled,
                culled_share=culled / max(tested + culled, 1))


def fmt_gate(g: dict) -> str:
    return (f"warp sub-blocks {g['tested']} tested, {g['culled']} culled "
            f"({100 * g['culled_share']:.1f}%)")


def fmt_work(w: dict) -> str:
    return (f"{w['items']} work items ({w['records']} ray tiles with work, "
            f"at most {w['max_chunks']} chunks)")


def searching_rays(rays, answer, any_hit: bool):
    """What an exact sweep's answer says of its last state: (need,
    useful), per ray whether it searches to the end (closest: every live
    ray; any-hit: the live rays the answer leaves without a hit) and the
    largest t it must search to (closest: min(t, maxt); any-hit:
    maxt)."""
    import torch

    t, idx = answer[0], answer[1]
    live = rays[6] <= rays[7]
    if any_hit:
        return live & (idx < 0), rays[7]
    return live, torch.minimum(t, rays[7])


def keys_needed(keys, bits: int, rays, answer, any_hit: bool,
                sub_boxes=None, per_warp: bool = False):
    """Triangle groups per ray tile that a sweep over sorted entry keys
    (K2, K2-mxu, K4: tiles; K5, K5-cull: slabs) must test whatever its
    schedule, from the inputs and the answer alone: the candidates whose
    entry bound (the key's) does not exceed the ray tile's final
    skyline, the largest useful t among the rays that search to the
    end; every skyline of a walk is at least that.  With sub_boxes (the
    gate's, K5 and K5-cull), of those slabs the sub-blocks that such a
    ray enters within its useful t, less those of padding only (empty
    boxes, which no gate passes); per_warp counts a sub-block once for
    each warp (32 consecutive rays) that holds such a ray, as K5's
    per-warp gate tests it.  (n_rt,) int64: tiles or slabs, or
    sub-blocks."""
    import torch
    from nori_tpu_torch.accel import sweep

    need, useful = searching_rays(rays, answer, any_hit)
    n_rt, n_slabs = keys.shape
    cap = torch.where(need & (useful > 0), useful, 0.0)
    t_hi = cap.view(torch.int32).reshape(n_rt, 256).amax(1)
    alive = need.reshape(n_rt, 256).any(1) if any_hit else t_hi > 0
    mask = (1 << bits) - 1
    ent = keys & ~mask
    slabs = (ent <= t_hi[:, None]) & (ent < 0x7F800000) & alive[:, None]
    if sub_boxes is None:
        return slabs.sum(1)
    # the searching rays cut to their useful t, the others dead: K1 then
    # gives a finite entry where one of them enters a sub-block's box
    cut = rays.clone()
    cut[6] = torch.where(need, rays[6], 1.0)
    cut[7] = torch.where(need, useful, 0.0)
    per = 8 if per_warp else 1
    if per_warp:
        # each warp's rays alone in a ray tile of their own, the rest dead
        n = rays.shape[1]
        wide = torch.zeros((8, n * 8), dtype=rays.dtype, device=rays.device)
        wide[6] = 1.0
        lane = torch.arange(n, device=rays.device)
        wide[:, lane // 32 * 256 + lane % 32] = cut
        cut = wide
    real = sub_boxes[:, 0] <= sub_boxes[:, 3]
    enters = (torch.isfinite(sweep.entry_min(sub_boxes, cut))
              & real).reshape(n_rt, per, -1)
    by_slab = torch.zeros_like(slabs).scatter_(1, (keys & mask).long(), slabs)
    n_sub = sub_boxes.shape[0] // n_slabs
    return (by_slab.repeat_interleave(n_sub, dim=1)[:, None]
            & enters).sum((1, 2))


def mt_needed(sd, rays, answer, any_hit: bool):
    """Tiles of 512 triangles per ray tile that the culled 2-D sweep (K6)
    must test whatever its schedule, from the inputs and the answer
    alone: those whose entry bound does not exceed the final skyline and
    whose box overlaps the final reach of the rays that search to the
    end (csrc/mt_sweep.cu reach_read); every reach of a walk contains
    that one.  (n_rt,) int64."""
    import torch
    from nori_tpu_torch.accel import sweep

    n_rt = rays.shape[1] // 256
    tb = sweep.coarse_bounds(sd.tri_tile_bounds,
                             sd.tri_packed.shape[1] // sweep.TILE_T)
    need, useful = searching_rays(rays, answer, any_hit)
    o, d = rays[0:3], rays[3:6]
    centre, radius = sd.scene_bounds[0, 0:3], sd.scene_bounds[0, 3]
    far = torch.sqrt(((o - centre[:, None]) ** 2).sum(0)) + radius

    def per_tile(x, fill, red):
        return red(torch.where(need, x, fill).reshape(-1, n_rt, 256), dim=-1)

    t_hi = per_tile(torch.minimum(useful, far), 0.0,
                    torch.amax)[0].clamp_min(0.0)
    lo = (per_tile(o, 3e37, torch.amin)
          + t_hi * per_tile(d, 0.0, torch.amin).clamp_max(0.0))
    hi = (per_tile(o, -3e37, torch.amax)
          + t_hi * per_tile(d, 0.0, torch.amax).clamp_min(0.0))
    overlap = ((hi.T[:, None, :] >= tb[None, :, 0:3])
               & (lo.T[:, None, :] <= tb[None, :, 3:6])).all(-1)
    entry = sweep.entry_min(tb, rays)
    searching = need.reshape(n_rt, 256).any(1)
    return ((entry <= t_hi[:, None]) & overlap & searching[:, None]).sum(1)


def time_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm-up
    call).  The calls are enqueued while the card still spins on an
    earlier kernel, so the time between the events holds no wait for the
    host: a wrapper's enqueue takes tens of microseconds, which is more
    than K1 and K3 run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(4_000_000)  # ~2 ms: the queue fills behind it
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    from nori_tpu_torch import cuda_build

    t0 = time.time()
    cuda_build.load()
    dt = time.time() - t0
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: {dt:.1f} s ({os.path.basename(cuda_build.library_path())})")
    return dt


def wavefront_rays(scene, sd, dev, n_lanes: int):
    """(camera+bounce rays, shadow rays), each packed (8, n_lanes): the
    lane state after two wavefront steps (regenerated camera rays and
    sorted bounce rays, idle lanes included) and NEE-style shadow rays
    from their closest hits to points on the emitters."""
    import numpy as np
    import torch
    from nori_tpu_torch.accel import sweep, traverse
    from nori_tpu_torch.integrators.base import (
        sample_emitter_point_fast, shadow_ray_args)
    from nori_tpu_torch.integrators.path import MIS
    from nori_tpu_torch.wavefront import make_wavefront_stepper

    spp = scene.sampler.sample_count
    w, h = scene.camera.output_size
    init, step, _, _ = make_wavefront_stepper(
        scene, MIS, n_lanes, 8 * n_lanes // spp * spp, device=dev)
    carry = init(SEED, 0, w * h * spp)
    for _ in range(2):
        carry = step(sd, carry, SEED)
    st = carry[0]
    rays, _ = sweep.pack_rays(st["o"], st["d"], st["mint"], st["maxt"])
    hit = traverse.intersect(sd, st["o"], st["d"], st["mint"], st["maxt"])
    p = st["o"] + torch.where(hit.valid, hit.t, 0.0)[:, None] * st["d"]
    rng = np.random.default_rng(SEED)
    u = torch.from_numpy(rng.random((n_lanes, 3), np.float32)).to(dev)
    y, _, _, _ = sample_emitter_point_fast(sd, u[:, 0], u[:, 1:3])
    wo, _, smint, smaxt = shadow_ray_args(p, y)
    smaxt = torch.where(hit.valid, smaxt, -1.0)
    shadow, _ = sweep.pack_rays(p, wo, smint, smaxt)
    return rays, shadow


def key_rows(kernel: str, inputs: dict) -> dict:
    """K1 ("entry_min") or K3 ("lane_keys") against its plain version on
    each of `inputs` {label: (bounds, rays)}, bit for bit (the plain
    version runs on slices of 65,536 rays: its temporaries grow with rays
    x boxes).  Returns {label: row}: the device time, the plain version's,
    and three counts of ray-box tests, from the inputs alone
    (keys_inputs.gate_counts): `tests_dense` rays x boxes; `tests_needed`,
    what a gate on the kernel's groups of consecutive boxes leaves when a
    group's boxes are tested for the rays that enter its box, which the
    bound counts; `tests`, what the kernel does (K1 the same; K3, which
    gates per warp of 32 lanes, the boxes of every group that a lane of
    the warp enters)."""
    import torch
    from keys_inputs import gate_counts
    from nori_tpu_torch.accel import sweep

    k1 = kernel == "entry_min"
    fn, plain = ((sweep.entry_min, sweep.entry_min_plain) if k1 else
                 (sweep.lane_keys, sweep.lane_keys_plain))
    rows = {}
    for label, (bounds, rays) in inputs.items():
        n, n_tt = rays.shape[1], bounds.shape[0]

        def sliced():
            parts = [plain(bounds, rays[:, c:c + 65536].contiguous())
                     for c in range(0, n, 65536)]
            return (torch.cat(parts) if k1 else
                    tuple(torch.cat(p) for p in zip(*parts)))

        got, ref = fn(bounds, rays), sliced()
        torch.cuda.synchronize()
        err = 0.0
        if k1:
            bad = got.view(torch.int32) != ref.view(torch.int32)
            fin = torch.isfinite(ref)
            err = float((got - ref)[fin].abs().max()) if bool(fin.any()) else 0.0
        else:
            bad = (got[0] != ref[0]) | (got[1] != ref[1])
        if bool(bad.any()):
            raise AssertionError(
                f"{kernel} differs from its plain version on {label} in "
                f"{int(bad.sum())} of {bad.numel()} entries")
        del got, ref, bad
        group = sweep.KEY_GROUP if k1 else sweep.lane_group(n_tt)
        needed = tested = dense = float(n) * n_tt
        if group:
            c = gate_counts(bounds, rays, (group,))[f"g{group}"]
            needed = c["per_ray"] * n
            tested = needed if k1 else c["per_warp"] * n
        out_words = n // 256 * n_tt if k1 else 2 * n
        rows[label] = dict(
            rays=n, boxes=n_tt, group=group, max_abs_err=err,
            ms=time_ms(lambda: fn(bounds, rays), 10),
            plain_ms=time_ms(sliced, 1), tests=tested, tests_needed=needed,
            tests_dense=dense,
            **bound(float(SLAB_OPS) * needed,
                    4.0 * (8 * n_tt + 8 * n + out_words)))
        log(f"{KERNELS[kernel][0]} {kernel} {label} ({n} rays x {n_tt} "
            f"boxes): bit-exact; {rows[label]['ms']:.4f} ms vs plain "
            f"{rows[label]['plain_ms']:.3f} ms, bound "
            f"{rows[label]['bound_ms']:.4f} ms; groups of {group}: "
            f"{tested / n:.1f} tests per ray done, {needed / n:.1f} needed, "
            f"of {n_tt} dense")
    return rows


def key_record(kernel: str, rows: dict, main: str) -> dict:
    """The JSON record of K1 or K3 from key_rows' rows: the numbers of
    row `main`, every row under by_input."""
    r = rows[main]
    return record(kernel, r["ms"], r["plain_ms"],
                  max(x["max_abs_err"] for x in rows.values()), r["ops"],
                  r["bytes"], by_input=rows)


def check_kernels(sd, rays, shadow, k1, k3) -> dict:
    """K1, K2 and K3 against their plain versions on the same rays, K1
    and K3 also on `k1` and `k3`, keys_inputs.room_inputs' {label:
    (bounds, rays)} (the check rays and a steady 524,288-lane step's);
    returns {kernel name: JSON record} (launch counts filled in
    later)."""
    import torch
    from nori_tpu_torch.accel import sweep

    tb = sd.tri_tile_bounds
    n, n_tt, T = rays.shape[1], tb.shape[0], sd.tri_bw.shape[1]
    live = int((rays[6] <= rays[7]).sum())
    live_s = int((shadow[6] <= shadow[7]).sum())
    log(f"check rays: {n} lanes, {live} live camera/bounce, "
        f"{live_s} live shadow; {n_tt} tiles, {T} triangles")
    records = {}

    # K1: bit-exact
    records["entry_min"] = key_record("entry_min", key_rows("entry_min", k1),
                                      "room check closest")

    # K2: hit masks equal, idx equal except at ties, t within rtol 1e-6
    err = 0.0
    timing = {}
    for label, op, r, any_hit in (
            ("bw closest", sd.tri_bw, rays, False),
            ("mt closest", sd.tri_packed, rays, False),
            ("bw any-hit", sd.tri_bw, shadow, True)):
        keys, bits = sweep.ray_tile_entry_keys(tb, r)
        t_k, i_k = sweep.resident_sweep(op, keys, bits, r, any_hit)
        t_p, i_p = sweep.resident_sweep_plain(op, r, any_hit)
        torch.cuda.synchronize()
        hit_k, hit_p = i_k >= 0, i_p >= 0
        n_mask = int((hit_k != hit_p).sum())
        if n_mask:
            raise AssertionError(f"resident_sweep {label}: hit mask differs "
                                 f"from its plain version on {n_mask} rays")
        if not any_hit:
            both = hit_k & hit_p
            dt = (t_k - t_p)[both].abs()
            tol = 1e-6 * t_p[both].abs()
            if bool((dt > tol).any()):
                raise AssertionError(
                    f"resident_sweep {label}: t differs by up to "
                    f"{float(dt.max())} (rtol 1e-6)")
            n_idx = int((i_k != i_p)[both].sum())
            if n_idx:
                raise AssertionError(
                    f"resident_sweep {label}: {n_idx} closest-hit triangles "
                    "differ from the plain version")
            # the tail pass's packed fold keeps t's bits, -0 included
            n_bits = int((t_k.view(torch.int32)
                          != t_p.view(torch.int32))[both].sum())
            if n_bits:
                raise AssertionError(
                    f"resident_sweep {label}: t bits differ from the plain "
                    f"version on {n_bits} rays")
            err = max(err, float(dt.max()) if dt.numel() else 0.0)
        visits, items = resident_run(
            lambda v, ws: sweep.resident_sweep(op, keys, bits, r, any_hit,
                                               visits=v, workspace=ws),
            r, n_tt)
        # the bound counts the tiles the answer shows to be needed, not
        # the ones this run's schedule happened to test
        pairs = int(keys_needed(keys, bits, r, (t_p, i_p), any_hit).sum()) * (
            sweep.FINE_T * 256)
        tested = int(visits.sum()) * sweep.FINE_T * 256
        timing[label] = dict(
            ms=time_ms(lambda: sweep.resident_sweep(op, keys, bits, r,
                                                    any_hit)),
            plain_ms=time_ms(lambda: sweep.resident_sweep_plain(op, r,
                                                                any_hit), 1),
            pairs=pairs, tiles_per_ray_tile=pairs / 128 / n,
            pairs_tested=tested, tested_per_ray_tile=tested / 128 / n,
            visits=visit_stats(visits), tail_items=items)
        log(f"K2 resident_sweep {label}: {int(hit_k.sum())} hits agree; "
            f"{timing[label]['ms']:.3f} ms vs plain "
            f"{timing[label]['plain_ms']:.3f} ms; "
            f"{pairs / 128 / n:.2f} tiles needed per ray tile, "
            f"{tested / 128 / n:.2f} tested; "
            f"{fmt_stats(timing[label]['visits'])}; {items} tail items")
    bw = timing["bw closest"]
    records["resident_sweep"] = record(
        "resident_sweep", bw["ms"], bw["plain_ms"], err,
        float(PAIR_OPS["bw"]) * bw["pairs"], sweep_bytes(12, T, n, n_tt),
        by_query=timing)

    # K3: bit-exact, on the coarsened bounds the wavefront sorts by
    records["lane_keys"] = key_record("lane_keys", key_rows("lane_keys", k3),
                                      "room check")
    return records


def check_merged_mxu_k6(sd, rays, shadow) -> dict:
    """K4, K2-mxu and K6 against their plain versions on the wavefront's
    rays and their shadow rays; returns {kernel name: JSON record}."""
    import torch
    from nori_tpu_torch.accel import sweep

    tb = sd.tri_tile_bounds
    n, n_tt, T = rays.shape[1], tb.shape[0], sd.tri_bw.shape[1]
    records = {}

    # K4 on [rays | shadow]: the plain version, and the two K2 launches
    # it replaces, exactly
    both = torch.cat([rays, shadow], dim=1).contiguous()
    n2 = both.shape[1]
    flags = (torch.arange(n2 // 256, device=rays.device) >= n // 256).to(
        torch.int32)
    keys, bits = sweep.ray_tile_entry_keys(tb, both)
    t_m, i_m = sweep.resident_sweep_mixed(sd.tri_bw, keys, bits, both, flags)
    t_p, i_p = sweep.resident_sweep_plain(sd.tri_bw, both)
    err = compare_sweep("resident_sweep_mixed closest tiles",
                        (t_m[:n], i_m[:n]), (t_p[:n], i_p[:n]), False)
    compare_sweep("resident_sweep_mixed any-hit tiles", (t_m[n:], i_m[n:]),
                  (t_p[n:], i_p[n:]), True)
    kc, bc = sweep.ray_tile_entry_keys(tb, rays)
    ks, bs = sweep.ray_tile_entry_keys(tb, shadow)
    t_c, i_c = sweep.resident_sweep(sd.tri_bw, kc, bc, rays, False)
    _, i_s = sweep.resident_sweep(sd.tri_bw, ks, bs, shadow, True)
    torch.cuda.synchronize()
    if not (torch.equal(t_m[:n], t_c) and torch.equal(i_m[:n], i_c)):
        raise AssertionError("resident_sweep_mixed: closest tiles differ "
                             "from the closest K2 launch")
    if not torch.equal(i_m[n:] >= 0, i_s >= 0):
        raise AssertionError("resident_sweep_mixed: any-hit tiles differ "
                             "from the any-hit K2 launch")
    visits, items = resident_run(lambda v, ws: sweep.resident_sweep_mixed(
        sd.tri_bw, keys, bits, both, flags, visits=v, workspace=ws), both,
        n_tt)
    needed = (keys_needed(kc, bc, rays, (t_p[:n], i_p[:n]), False).sum()
              + keys_needed(ks, bs, shadow, (None, i_p[n:]), True).sum())
    pairs = int(needed) * sweep.FINE_T * 256
    tested = int(visits.sum()) * sweep.FINE_T * 256
    ms = time_ms(lambda: sweep.resident_sweep_mixed(sd.tri_bw, keys, bits,
                                                    both, flags))
    ms_two = time_ms(lambda: (
        sweep.resident_sweep(sd.tri_bw, kc, bc, rays, False),
        sweep.resident_sweep(sd.tri_bw, ks, bs, shadow, True)))
    records["resident_sweep_mixed"] = record(
        "resident_sweep_mixed", ms,
        time_ms(lambda: sweep.resident_sweep_plain(sd.tri_bw, both), 1),
        err, float(PAIR_OPS["bw"]) * pairs,
        sweep_bytes(12, T, n2, n_tt) + 4.0 * (n2 // 256),
        two_k2_ms=ms_two, tiles_per_ray_tile=pairs / 128 / n2,
        pairs_tested=tested, tested_per_ray_tile=tested / 128 / n2,
        visits=visit_stats(visits), tail_items=items)
    log(f"K4 resident_sweep_mixed ({n} closest + {n} shadow rays): equal to "
        f"its plain version and to the two K2 launches; {ms:.3f} ms vs the "
        f"two K2 launches {ms_two:.3f} ms vs plain "
        f"{records['resident_sweep_mixed']['plain_ms']:.3f} ms; "
        f"{pairs / 128 / n2:.2f} tiles needed per ray tile, "
        f"{tested / 128 / n2:.2f} tested; "
        f"{fmt_stats(records['resident_sweep_mixed']['visits'])}; "
        f"{items} tail items")

    # K2-mxu: exact against its plain version; hit masks against BW K2
    keys, bits = sweep.ray_tile_entry_keys(tb, rays)
    t_x, i_x = sweep.resident_sweep_mxu(sd.tri_mxu, keys, bits, rays)
    t_p, i_p = sweep.resident_sweep_mxu_plain(sd.tri_mxu, rays)
    torch.cuda.synchronize()
    if not (torch.equal(i_x, i_p) and torch.equal(t_x[i_p >= 0],
                                                   t_p[i_p >= 0])):
        raise AssertionError(
            f"resident_sweep_mxu differs from its plain version on "
            f"{int((i_x != i_p).sum())} rays")
    agree = float(((i_x >= 0) == (i_c >= 0)).float().mean())
    same_tri = float((i_x == i_c).float().mean())
    if agree < 0.999:
        raise AssertionError(f"resident_sweep_mxu: hit masks agree with BW "
                             f"K2 on only {agree:.5f} of rays")
    _, i_xs = sweep.resident_sweep_mxu(sd.tri_mxu, ks, bs, shadow, True)
    _, i_ps = sweep.resident_sweep_mxu_plain(sd.tri_mxu, shadow, True)
    if not torch.equal(i_xs >= 0, i_ps >= 0):
        raise AssertionError("resident_sweep_mxu any-hit: hit mask differs "
                             "from its plain version")
    visits, items = resident_run(lambda v, ws: sweep.resident_sweep_mxu(
        sd.tri_mxu, keys, bits, rays, visits=v, workspace=ws), rays, n_tt)
    pairs = int(keys_needed(keys, bits, rays, (t_p, i_p), False).sum()) * (
        sweep.FINE_T * 256)
    tested = int(visits.sum()) * sweep.FINE_T * 256
    records["resident_sweep_mxu"] = record(
        "resident_sweep_mxu",
        time_ms(lambda: sweep.resident_sweep_mxu(sd.tri_mxu, keys, bits,
                                                 rays)),
        time_ms(lambda: sweep.resident_sweep_mxu_plain(sd.tri_mxu, rays), 1),
        0.0, float(PAIR_OPS["mxu"]) * pairs, sweep_bytes(40, T, n, n_tt),
        hit_mask_agreement_with_bw=agree, same_triangle_as_bw=same_tri,
        tiles_per_ray_tile=pairs / 128 / n, pairs_tested=tested,
        tested_per_ray_tile=tested / 128 / n, visits=visit_stats(visits),
        tail_items=items)
    log(f"K2-mxu resident_sweep_mxu: exact against its plain version "
        f"(closest and any-hit); hit masks agree with BW K2 on {agree:.6f}, "
        f"triangles on {same_tri:.6f} of rays; "
        f"{records['resident_sweep_mxu']['ms']:.3f} ms vs plain "
        f"{records['resident_sweep_mxu']['plain_ms']:.3f} ms; "
        f"{pairs / 128 / n:.2f} tiles needed per ray tile, "
        f"{tested / 128 / n:.2f} tested; "
        f"{fmt_stats(records['resident_sweep_mxu']['visits'])}; "
        f"{items} tail items")
    records["mt_sweep"] = check_k6(sd, rays, shadow)
    return records


def check_k6(sd, rays, shadow) -> dict:
    """K6, culled, closest and any-hit, against its plain version: hit
    masks equal; for closest hits t, u and v equal and idx equal except
    at exact ties in t (the kernel keeps the earlier visit)."""
    import torch
    from nori_tpu_torch.accel import sweep

    args = (sd.tri_packed, sd.tri_tile_bounds, sd.scene_bounds)
    n, T = rays.shape[1], sd.tri_packed.shape[1]
    n_tt = T // sweep.TILE_T
    for label, r, any_hit in (("closest", rays, False),
                              ("any-hit", shadow, True)):
        t_k, i_k, u_k, v_k = sweep.mt_sweep(*args, r, any_hit=any_hit)
        t_p, i_p, u_p, v_p = sweep.mt_sweep_plain(sd.tri_packed, r)
        torch.cuda.synchronize()
        hit = i_p >= 0
        if not torch.equal(i_k >= 0, hit):
            raise AssertionError(f"mt_sweep {label}: hit mask differs from "
                                 f"its plain version on "
                                 f"{int(((i_k >= 0) != hit).sum())} rays")
        if any_hit:
            continue
        if not torch.equal(t_k[hit], t_p[hit]):
            raise AssertionError(f"mt_sweep {label}: t differs from its "
                                 "plain version")
        same = hit & (i_k == i_p)
        diff = hit & (i_k != i_p)
        if bool(diff.any()):
            # a different winner only at an exact tie in t
            rd = r[:, diff]
            o3, d3 = (rd[0], rd[1], rd[2]), (rd[3], rd[4], rd[5])
            ok_k, tt_k = sweep._pair_test(sd.tri_packed[:, i_k[diff].long()],
                                          o3, d3, rd[6], rd[7])
            ok_p, tt_p = sweep._pair_test(sd.tri_packed[:, i_p[diff].long()],
                                          o3, d3, rd[6], rd[7])
            if not (bool(ok_k.all()) and bool(ok_p.all())
                    and torch.equal(tt_k, tt_p)):
                raise AssertionError(f"mt_sweep {label}: a winner differs "
                                     "from its plain version off a tie")
            log(f"  mt_sweep {label}: {int(diff.sum())} winners differ at "
                "exact ties in t")
        if not (torch.equal(u_k[same], u_p[same])
                and torch.equal(v_k[same], v_p[same])):
            raise AssertionError(f"mt_sweep {label}: u or v differs from "
                                 "its plain version")
    timing = {}
    for label, r, any_hit in (("closest", rays, False),
                              ("any-hit", shadow, True)):
        visits, work = stream_run(
            lambda v, ws: sweep.mt_sweep(*args, r, any_hit=any_hit, visits=v,
                                         workspace=ws), r)
        # the bound counts the tiles the answer shows to be needed, not
        # the ones this run's schedule happened to test
        pairs = int(mt_needed(sd, r, sweep.mt_sweep_plain(sd.tri_packed, r),
                              any_hit).sum()) * sweep.TILE_T * 256
        tested = int(visits.sum()) * sweep.TILE_U * 256
        timing[label] = dict(
            ms=time_ms(lambda: sweep.mt_sweep(*args, r, any_hit=any_hit)),
            pairs=pairs, tiles_per_ray_tile=pairs / 512 / n,
            pairs_tested=tested, tested_per_ray_tile=tested / 512 / n,
            visits=visit_stats(visits), work=work,
            **bound(float(PAIR_OPS["mt"]) * pairs + float(SLAB_OPS) * n * n_tt,
                    4.0 * (9 * T + 8 * n + 8 * n_tt + 4 * n)))
        log(f"K6 mt_sweep {label}: {timing[label]['ms']:.3f} ms (with its K1 "
            f"and argsort), bound {timing[label]['bound_ms']:.3f} ms; "
            f"{pairs / 512 / n:.2f} tiles needed per ray tile, "
            f"{tested / 512 / n:.2f} tested; quarter tiles, "
            f"{fmt_stats(timing[label]['visits'])}; {fmt_work(work)}")
    cl = timing["closest"]
    rec = record(
        "mt_sweep", cl["ms"],
        time_ms(lambda: sweep.mt_sweep_plain(sd.tri_packed, rays), 1), 0.0,
        cl["ops"], cl["bytes"], tiles_per_ray_tile=cl["tiles_per_ray_tile"],
        by_query=timing)
    log(f"K6 mt_sweep (culled, {n_tt} tiles of 512): closest t, u, v equal "
        f"to its plain version, any-hit masks equal; {rec['ms']:.3f} ms vs "
        f"plain {rec['plain_ms']:.3f} ms")
    return rec


def k6_path(sd, rays, shadow) -> dict:
    """The 2-D sweep as a caller drives it: closest hits of the
    wavefront's rays and any hits of their shadow rays; returns the
    launch counts of that run."""
    import torch
    from nori_tpu_torch.accel import sweep

    reset_launches()
    for r, any_hit in ((rays, False), (shadow, True)):
        sweep.mt_sweep(sd.tri_packed, sd.tri_tile_bounds, sd.scene_bounds, r,
                       any_hit=any_hit)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"K6 path: launches {launches}")
    if launches["mt_sweep"] != 2:
        raise AssertionError("mt_sweep was not launched for both queries")
    return launches


def parity_render(dev, cfg=PARITY, label: str = "parity render"):
    """The port on the card vs the port on the CPU (plain versions):
    ray counts within 0.1% and the exact image gate of
    scripts/rmse_gate.py (RMSE < 1e-3 and < 1% of pixels off by more
    than 1e-3)."""
    import numpy as np
    from nori_tpu_torch.scenes_builtin import living_room
    from nori_tpu_torch.wavefront import render_wavefront

    out = {}
    for d in (dev, "cpu"):
        scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                            detail=cfg["detail"])
        out[str(d)] = render_wavefront(scene, seed=SEED,
                                       n_lanes=cfg["n_lanes"], device=d)
    (img_c, st_c), (img_p, st_p) = out[str(dev)], out["cpu"]
    rel = abs(st_c["rays"] - st_p["rays"]) / max(st_p["rays"], 1)
    diff = np.abs(img_c - img_p)
    rmse = float(np.sqrt(np.mean((img_c - img_p) ** 2)))
    off = float(np.mean(diff.max(axis=-1) > 1e-3))
    log(f"{label} {cfg['width']}x{cfg['height']} spp {cfg['spp']}: "
        f"rays {st_c['rays']} (card) vs {st_p['rays']} (cpu), rmse {rmse:.3e}, "
        f"pixels off {off:.4f}, max |diff| {float(diff.max()):.3e}; "
        f"{st_c['seconds']:.2f} s card, {st_p['seconds']:.2f} s cpu")
    if rel > 1e-3:
        raise AssertionError(f"{label}: ray counts differ by {rel:.2%}")
    if not (rmse < 1e-3 and off < 0.01):
        raise AssertionError(f"{label}: images fail the exact gate")


def full_render(dev, label: str, merged: bool = False,
                sweep_kernel: str = "resident_sweep"):
    """The full living-room render through render_to_files (see FULL),
    which must launch K1, K3 and `sweep_kernel`; returns (image, stats,
    the launch counts of the render)."""
    import numpy as np
    import torch
    from nori_tpu_torch.render import render_to_files
    from nori_tpu_torch.scenes_builtin import living_room

    cfg = FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    n_tris = scene.compile_arrays()["tri_bw"].shape[1]
    with tempfile.TemporaryDirectory() as tmp, switches(MERGED_SWEEP=merged):
        base = os.path.join(tmp, "living_room")
        torch.cuda.synchronize()
        reset_launches()
        img, st = render_to_files(scene, base, seed=SEED,
                                  n_lanes=cfg["n_lanes"], device=dev)
        torch.cuda.synchronize()
        launches = read_launches()
        for ext in (".exr", ".png"):
            if os.path.getsize(base + ext) == 0:
                raise AssertionError(f"empty {ext} output")
    log(f"{label} {cfg['width']}x{cfg['height']} spp {st['spp']}, "
        f"{n_tris} padded triangles, {cfg['n_lanes']} lanes, merged "
        f"{st['merged']}: {st['seconds']:.2f} s")
    log(f"  rays {st['rays']}, {st['mrays_per_sec']:.3f} Mrays/s, "
        f"{st['samples_per_sec']:.1f} samples/s, occupancy "
        f"{st['occupancy']:.4f}, steps {st['steps']} "
        f"(wide {st['wide_steps']})")
    log(f"  launches {launches}")
    if st["merged"] != merged:
        raise AssertionError(f"{label}: merged is {st['merged']}")
    if img.shape != (cfg["height"], cfg["width"], 3):
        raise AssertionError(f"image shape {img.shape}")
    if not np.isfinite(img).all():
        raise AssertionError("image holds non-finite values")
    mean = float(img.mean())
    log(f"  mean radiance {mean:.4f} (expected {MEAN_RANGE})")
    if not MEAN_RANGE[0] <= mean <= MEAN_RANGE[1]:
        raise AssertionError(f"mean radiance {mean} outside {MEAN_RANGE}")
    for name in ("entry_min", "lane_keys", sweep_kernel):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    return img, st, launches


def merged_renders(dev, img_two, st_two) -> dict:
    """The full render with the merged step, alternated with the
    two-launch render (two-launch, merged, merged, two-launch, the
    first given): every image bit-equal to the two-launch one, the same
    rays; K4 on every step and K2 exactly once (the priming sweep of
    the one chunk).  Returns the first merged render's launches and
    both series of times."""
    import numpy as np

    times = {"two_launch": [st_two["seconds"]], "merged": []}
    out = None
    for i, merged in enumerate((True, True, False)):
        label = "merged render" if merged else "two-launch render"
        img, st, launches = full_render(
            dev, f"{label} {i + 1}", merged,
            "resident_sweep_mixed" if merged else "resident_sweep")
        times["merged" if merged else "two_launch"].append(st["seconds"])
        if st["rays"] != st_two["rays"] or not np.array_equal(img, img_two):
            raise AssertionError(f"{label} {i + 1}: image or rays differ from "
                                 "the two-launch render")
        if merged:
            if launches["resident_sweep_mixed"] != st["steps"]:
                raise AssertionError(
                    f"K4 launched {launches['resident_sweep_mixed']} times "
                    f"in {st['steps']} steps")
            if launches["resident_sweep"] != 1:
                raise AssertionError(
                    f"K2 launched {launches['resident_sweep']} times; the "
                    "merged render primes once")
            out = out or launches
    log(f"merged vs two-launch: images bit-equal, rays equal; seconds "
        f"two-launch {times['two_launch']}, merged {times['merged']}")
    return dict(launches=out, seconds=times)


def mxu_renders(dev, img_bw, st_bw) -> dict:
    """USE_MXU_SWEEP: the parity render card vs CPU (exact gate), then
    the full render: mean radiance within 1% of the BW render's, rays
    within 0.1% (a changed hit re-seeds a path, so not bit-equal).
    Returns the full render's launches."""
    with switches(USE_MXU_SWEEP=True):
        parity_render(dev, MXU_PARITY, "mxu parity render")
        img, st, launches = full_render(dev, "mxu full render",
                                        sweep_kernel="resident_sweep_mxu")
    if launches["resident_sweep"] or not launches["resident_sweep_mxu"]:
        raise AssertionError("the MXU render did not sweep with K2-mxu")
    d_mean = abs(float(img.mean()) / float(img_bw.mean()) - 1.0)
    d_rays = abs(st["rays"] / st_bw["rays"] - 1.0)
    log(f"mxu vs bw full render: mean radiance {float(img.mean()):.6f} vs "
        f"{float(img_bw.mean()):.6f} ({d_mean:.3e} apart), rays "
        f"{st['rays']} vs {st_bw['rays']} ({d_rays:.3e} apart)")
    if d_mean > 0.01 or d_rays > 1e-3:
        raise AssertionError("mxu render: mean radiance or rays off the BW "
                             "render's")
    return dict(launches=launches, seconds=st["seconds"], rays=st["rays"],
                mean_rel_diff=d_mean, rays_rel_diff=d_rays)


# ---------------------------------------------------------------------------
# the streamed path: the ajax composition through the batch driver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    log(f"== {name}")
    yield
    log(f"== {name}: {time.time() - t0:.1f} s")


def ajax_rays(scene, sd, dev, q):
    """(camera rays, shadow rays), each packed (8, n): the batch
    driver's camera rays for the n work items q, and whitted's depth-0
    shadow rays from their hits to points on the emitter (streams 1 and
    2), empty where there is no hit or the sample faces away."""
    import torch
    from nori_tpu_torch.accel import sweep, traverse
    from nori_tpu_torch.core.vecmath import dot
    from nori_tpu_torch.integrators.base import (
        lane_uniform, lane_uniform2, sample_emitter_point_fast,
        shadow_ray_args)
    from nori_tpu_torch.interaction import fill_interaction_fast
    from nori_tpu_torch.render import camera_rays

    spp = scene.sampler.sample_count
    _, o, d, mint, maxt = camera_rays(
        scene, scene.camera.ray_params(dev), q // spp, q, SEED)
    rays, _ = sweep.pack_rays(o, d, mint, maxt)
    its = fill_interaction_fast(sd, traverse.intersect(sd, o, d, mint, maxt),
                                o, d)
    y, n_y, _, _ = sample_emitter_point_fast(
        sd, lane_uniform(SEED, q, 1), lane_uniform2(SEED, q, 2))
    wo, _, smint, smaxt = shadow_ray_args(its.p, y)
    smaxt = torch.where(its.valid & (dot(n_y, -wo) > 0.0), smaxt, -1.0)
    shadow, _ = sweep.pack_rays(its.p, wo, smint, smaxt)
    return rays, shadow


def compare_sweep(label: str, got, ref, any_hit: bool,
                  bits: bool = False) -> float:
    """Equal hit masks, and for closest hits t within rtol 1e-6 and
    equal triangles (the kernels round as their plain versions and
    break ties alike), with `bits` also equal t bits (-0 included);
    returns max |dt|."""
    import torch

    (t_k, i_k), (t_p, i_p) = got, ref
    torch.cuda.synchronize()
    hit_k, hit_p = i_k >= 0, i_p >= 0
    n_mask = int((hit_k != hit_p).sum())
    if n_mask:
        raise AssertionError(f"{label}: hit mask differs from its plain "
                             f"version on {n_mask} rays")
    if any_hit:
        return 0.0
    both = hit_k & hit_p
    dt = (t_k - t_p)[both].abs()
    if bool((dt > 1e-6 * t_p[both].abs()).any()):
        raise AssertionError(f"{label}: t differs by up to "
                             f"{float(dt.max())} (rtol 1e-6)")
    n_idx = int((i_k != i_p)[both].sum())
    if n_idx:
        raise AssertionError(f"{label}: {n_idx} closest-hit triangles differ "
                             "from the plain version")
    if bits:
        n_bits = int((t_k.view(torch.int32) != t_p.view(torch.int32))[
            both].sum())
        if n_bits:
            raise AssertionError(f"{label}: t bits differ from the plain "
                                 f"version on {n_bits} rays")
    return float(dt.max()) if dt.numel() else 0.0


def check_ajax_kernels(dev) -> dict:
    """K1 and K3 on the 1,058 slab bounds (the check rays and one whole
    whitted batch's) and K5 (BW closest, MT closest, BW any-hit) against
    their plain versions; returns {kernel name: record}."""
    import torch
    from nori_tpu_torch.accel import sweep

    from keys_inputs import ajax_inputs

    # the 32,768 check rays spread evenly over the image, and what one
    # whole whitted batch hands K1 and K3
    sd, k1, k3 = ajax_inputs(sys.modules[__name__], dev)
    tb = sd.tri_tile_bounds
    if sd.tri_bw.shape != (16, AJAX_TRIS) or tb.shape[0] != AJAX_SLABS:
        raise AssertionError(f"ajax layout {tuple(sd.tri_bw.shape)}, "
                             f"{tb.shape[0]} slabs")
    rays, shadow = k1["ajax check closest"][1], k1["ajax check shadow"][1]
    n = rays.shape[1]
    live = int((rays[6] <= rays[7]).sum())
    live_s = int((shadow[6] <= shadow[7]).sum())
    log(f"ajax check rays: {rays.shape[1]} camera ({live} live), "
        f"{live_s} live shadow; {tb.shape[0]} slabs of 512")
    out = {}
    rows = key_rows("entry_min", k1)
    out["entry_min"] = dict(rows["ajax check closest"], by_input=rows)
    rows = key_rows("lane_keys", k3)
    out["lane_keys"] = dict(rows["ajax check shadow"], by_input=rows)
    del k1, k3, rows
    n_tt, T = tb.shape[0], sd.tri_packed.shape[1]

    err, timing, uncut = 0.0, {}, {}
    for label, use_bw, r, any_hit in (
            ("bw closest", True, rays, False),
            ("mt closest", False, rays, False),
            ("bw any-hit", True, shadow, True),
            ("mt any-hit", False, shadow, True)):
        op = sd.tri_bw if use_bw else sd.tri_packed
        keys, bits = sweep.ray_tile_entry_keys(tb, r)

        def kern(v=None, ws=None, tally=None):
            return sweep.stream_sweep(op, keys, bits, r, any_hit, use_bw,
                                      visits=v, workspace=ws,
                                      sub_boxes=sd.tri_sub_boxes,
                                      tally=tally)

        def plain():
            return sweep.stream_sweep_plain(op, r, any_hit, use_bw)

        got, ref = kern(), plain()
        if not use_bw:
            uncut[any_hit] = got
        err = max(err, compare_sweep(f"stream_sweep {label}", got, ref,
                                     any_hit, bits=True))
        visits, work = stream_run(kern, r)
        gate_n = gate_tally(kern)
        # the bound counts the sub-blocks the answer shows to be needed
        # (in the slabs it needs), not the ones this run's gates let by
        g = sweep.STREAM_G
        slabs = int(keys_needed(keys, bits, r, ref, any_hit).sum())
        needed = int(keys_needed(keys, bits, r, ref, any_hit,
                                 sd.tri_sub_boxes, per_warp=True).sum())
        pairs, tested = needed * g * 32, int(visits.sum()) * g * 32
        timing[label] = dict(
            ms=time_ms(kern), plain_ms=time_ms(plain, 1), pairs=pairs,
            slabs_per_ray_tile=slabs / n_rt(n),
            warp_sub_blocks_per_ray_tile=needed / n_rt(n),
            pairs_tested=tested, tested_per_ray_tile=tested / 512 / n,
            visits=visit_stats(visits), work=work, gate=gate_n,
            **bound(float(PAIR_OPS["bw" if use_bw else "mt"]) * pairs,
                    sweep_bytes(12 if use_bw else 9, T, n, n_tt)))
        log(f"K5 stream_sweep {label}: {int((got[1] >= 0).sum())} hits "
            f"agree, t bits equal; {timing[label]['ms']:.3f} ms vs plain "
            f"{timing[label]['plain_ms']:.3f} ms, bound "
            f"{timing[label]['bound_ms']:.3f} ms; per ray tile "
            f"{slabs / n_rt(n):.2f} slabs needed, warp sub-blocks of {g}: "
            f"{needed / n_rt(n):.2f} needed, "
            f"{int(visits.sum()) / n_rt(n):.2f} tested; {fmt_gate(gate_n)}; "
            f"{fmt_stats(timing[label]['visits'])}; {fmt_work(work)}")
    timing.update(check_sorted_any_hit(sd, dev))
    bw = timing["bw closest"]
    out["stream_sweep"] = record(
        "stream_sweep", bw["ms"], bw["plain_ms"], err,
        float(PAIR_OPS["bw"]) * bw["pairs"], sweep_bytes(12, T, n, n_tt),
        by_query=timing)

    # K5-cull: the MT operand in sub-blocks of CULL_T, against its plain
    # version and against K5 uncut, exactly
    err, timing = 0.0, {}
    cull_bytes = sweep_bytes(9, T, n, n_tt) + 4.0 * 8 * (T // CULL_T)
    for label, r, any_hit in (("mt closest", rays, False),
                              ("mt any-hit", shadow, True)):
        keys, bits = sweep.ray_tile_entry_keys(tb, r)

        def kern(v=None, ws=None, tally=None):
            return sweep.stream_sweep_culled(sd.tri_packed, keys, bits, r,
                                             any_hit, CULL_T, visits=v,
                                             workspace=ws, tally=tally)

        def plain():
            return sweep.stream_sweep_plain(sd.tri_packed, r, any_hit, False)

        got, ref = kern(), plain()
        err = max(err, compare_sweep(f"stream_sweep_culled {label}", got,
                                     ref, any_hit, bits=True))
        (t_c, i_c), (t_u, i_u) = got, uncut[any_hit]
        same = (torch.equal(i_c >= 0, i_u >= 0) if any_hit else
                torch.equal(i_c, i_u) and torch.equal(t_c, t_u))
        if not same:
            raise AssertionError(f"stream_sweep_culled {label}: differs from "
                                 "K5")
        visits, work = stream_run(kern, r)
        gate_n = gate_tally(kern)
        # needed: the sub-blocks of the needed slabs that a ray searching
        # to the end enters in time
        pairs = int(keys_needed(
            keys, bits, r, ref, any_hit,
            sweep.sub_block_boxes(sd.tri_packed, CULL_T),
            per_warp=True).sum()) * CULL_T * 32
        tested = int(visits.sum()) * sweep.STREAM_G * 32
        timing[label] = dict(
            ms=time_ms(kern), plain_ms=time_ms(plain, 1), pairs=pairs,
            pairs_tested=tested,
            gated_ms=out["stream_sweep"]["by_query"][label]["ms"],
            visits=visit_stats(visits), work=work, gate=gate_n,
            **bound(float(PAIR_OPS["mt"]) * pairs, cull_bytes))
        log(f"K5-cull stream_sweep_culled {label}: equal to its plain "
            f"version (t bits too) and to K5; "
            f"{timing[label]['ms']:.3f} ms vs plain "
            f"{timing[label]['plain_ms']:.3f} ms, K5 "
            f"{timing[label]['gated_ms']:.3f} ms, bound "
            f"{timing[label]['bound_ms']:.3f} ms; warp sub-blocks of "
            f"{CULL_T}: {pairs / CULL_T / 32 / n_rt(n):.2f} needed per ray "
            f"tile, {tested / CULL_T / 32 / n_rt(n):.2f} tested; "
            f"{fmt_gate(gate_n)}; {fmt_stats(timing[label]['visits'])}; "
            f"{fmt_work(work)}")
    mt = timing["mt closest"]
    out["stream_sweep_culled"] = record(
        "stream_sweep_culled", mt["ms"], mt["plain_ms"], err,
        float(PAIR_OPS["mt"]) * mt["pairs"], cull_bytes, by_query=timing)
    return out


def check_sorted_any_hit(sd, dev):
    """K5 any-hit on the shadow rays of one whole 131,072-sample batch
    of ajax_rough, swept in the order traverse.occluded sorts them (K3
    keys on the 1,058 slab bounds), against the plain sweep of the same
    rays unsorted; then the kernel on the unsorted rays and
    traverse.occluded itself against it.  Returns {label: {ms,
    plain_ms, pairs, bound_ms, ...}} for the sorted and the unsorted
    order."""
    import torch
    from nori_tpu_torch.accel import sweep, traverse
    from nori_tpu_torch.render import DEFAULT_BATCH

    scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, 16, "whitted")
    q = AJAX_SORTED_BATCH * DEFAULT_BATCH + torch.arange(
        DEFAULT_BATCH, dtype=torch.int64, device=dev)
    _, shadow = ajax_rays(scene, sd, dev, q)
    perm = traverse.shadow_order(sd, shadow)
    srt = shadow[:, perm].contiguous()
    keys, bits = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, srt)
    keys_u, bits_u = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, shadow)

    def kern(v=None, ws=None, tally=None):
        return sweep.stream_sweep(sd.tri_bw, keys, bits, srt, True, True,
                                  visits=v, workspace=ws,
                                  sub_boxes=sd.tri_sub_boxes, tally=tally)

    def kern_unsorted(v=None, ws=None, tally=None):
        return sweep.stream_sweep(sd.tri_bw, keys_u, bits_u, shadow, True,
                                  True, visits=v, workspace=ws,
                                  sub_boxes=sd.tri_sub_boxes, tally=tally)

    _, idx = kern()
    hit_k = torch.empty_like(idx, dtype=torch.bool)
    hit_k[perm] = idx >= 0
    hit_u = kern_unsorted()[1] >= 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    _, idx_p = sweep.stream_sweep_plain(sd.tri_bw, shadow, True, True)
    end.record()
    torch.cuda.synchronize()
    hit_p = idx_p >= 0
    for label, hit in (("sorted", hit_k), ("unsorted", hit_u)):
        n_mask = int((hit != hit_p).sum())
        if n_mask:
            raise AssertionError(
                f"stream_sweep bw any-hit {label}: hit mask differs from "
                f"its plain version on {n_mask} rays")
    occ = traverse.occluded(sd, shadow[0:3].T, shadow[3:6].T, shadow[6],
                            shadow[7])
    n_occ = int((occ != hit_p).sum())
    if n_occ:
        raise AssertionError(f"traverse.occluded differs from the plain "
                             f"any-hit sweep on {n_occ} rays")
    ms, plain_ms = time_ms(kern), start.elapsed_time(end)
    ms_u = time_ms(kern_unsorted)
    sort_ms = time_ms(
        lambda: shadow[:, traverse.shadow_order(sd, shadow)].contiguous())
    # bounds as check_ajax_kernels' rows: the pairs each order of the
    # rays needs (keys_needed) x 40 ops (BW), every input byte once
    n, T = DEFAULT_BATCH, sd.tri_bw.shape[1]
    nbytes = sweep_bytes(12, T, n, sd.tri_tile_bounds.shape[0])
    ref_s = (None, torch.where(hit_p, 0, -1)[perm])
    ref_u = (None, torch.where(hit_p, 0, -1))
    out = {}
    for label, fn, t, kb, r, ref in (
            ("bw any-hit sorted", kern, ms, (keys, bits), srt, ref_s),
            ("bw any-hit unsorted", kern_unsorted, ms_u, (keys_u, bits_u),
             shadow, ref_u)):
        visits, work = stream_run(fn, r)
        gate_n = gate_tally(fn)
        g = sweep.STREAM_G
        slabs = int(keys_needed(*kb, r, ref, True).sum())
        needed = int(keys_needed(*kb, r, ref, True, sd.tri_sub_boxes,
                                 per_warp=True).sum())
        pairs, tested = needed * g * 32, int(visits.sum()) * g * 32
        out[label] = dict(ms=t, plain_ms=plain_ms, pairs=pairs,
                          slabs_per_ray_tile=slabs / n_rt(n),
                          warp_sub_blocks_per_ray_tile=needed / n_rt(n),
                          pairs_tested=tested,
                          tested_per_ray_tile=tested / 512 / n,
                          visits=visit_stats(visits), work=work, gate=gate_n,
                          **bound(float(PAIR_OPS["bw"]) * pairs, nbytes))
        log(f"K5 stream_sweep {label}: per ray tile {slabs / n_rt(n):.2f} "
            f"slabs needed, warp sub-blocks of {g}: {needed / n_rt(n):.2f} "
            f"needed, {int(visits.sum()) / n_rt(n):.2f} tested; "
            f"{fmt_gate(gate_n)}; {fmt_stats(out[label]['visits'])}; "
            f"{fmt_work(work)}")
    out["bw any-hit sorted"]["sort_ms"] = sort_ms
    log(f"K5 stream_sweep bw any-hit sorted (batch {AJAX_SORTED_BATCH}, "
        f"{DEFAULT_BATCH} rays, {int((shadow[6] <= shadow[7]).sum())} live): "
        f"{int(hit_p.sum())} hits agree, traverse.occluded agrees; "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
        f"{out['bw any-hit sorted']['bound_ms']:.3f} ms "
        f"({out['bw any-hit sorted']['warp_sub_blocks_per_ray_tile']:.2f} "
        f"warp sub-blocks per ray tile); the same rays unsorted agree too, "
        f"{ms_u:.3f} ms, bound {out['bw any-hit unsorted']['bound_ms']:.3f} "
        f"ms ({out['bw any-hit unsorted']['warp_sub_blocks_per_ray_tile']:.2f}"
        f"); "
        f"the sort "
        f"(K3, argsort, gather) {sort_ms:.3f} ms")
    return out


def gate(label: str, a, st_a, b, st_b, names=("card", "cpu")):
    """Equal ray counts and the exact image gate of scripts/rmse_gate.py
    (RMSE < 1e-3 and < 1% of pixels off by more than 1e-3)."""
    import numpy as np

    diff = np.abs(a - b)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    off = float(np.mean(diff.max(axis=-1) > 1e-3))
    na, nb = names
    log(f"{label}: rays {st_a['rays']} ({na}) vs {st_b['rays']} ({nb}), "
        f"rmse {rmse:.3e}, pixels off {off:.4f}, max |diff| "
        f"{float(diff.max()):.3e}, mean {float(a.mean()):.4f}; "
        f"{st_a['seconds']:.2f} s {na}, {st_b['seconds']:.2f} s {nb}")
    if st_a["rays"] != st_b["rays"]:
        raise AssertionError(f"{label}: ray counts differ")
    if not (rmse < 1e-3 and off < 0.01):
        raise AssertionError(f"{label}: images fail the exact gate")


def ajax_parity(dev):
    """The port on the card against the port on the CPU, on the full
    541,696-triangle ajax scene."""
    from nori_tpu_torch.render import render
    from nori_tpu_torch.wavefront import render_wavefront

    for integrator, size, spp, driver in AJAX_PARITY:
        out = []
        for d in (dev, "cpu"):
            scene = ajax_scene(size, size, spp, integrator)
            if driver == "render":
                out.append(render(scene, seed=SEED, device=d))
            else:
                out.append(render_wavefront(scene, seed=SEED, n_lanes=4096,
                                            device=d))
        (img_c, st_c), (img_p, st_p) = out
        gate(f"ajax parity {integrator} {size}x{size} spp {spp}", img_c, st_c,
             img_p, st_p)


def ajax_render(dev, name: str, integrator: str, spp: int, band,
                sweep_kernel: str = "stream_sweep"):
    """One full ajax render through render_to_files, which must launch
    K1 and `sweep_kernel` (and K3 for whitted's shadow sort) and never
    K2; returns (image, stats, the launch counts of the render)."""
    import numpy as np
    import torch
    from nori_tpu_torch.render import render_to_files

    scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, spp, integrator)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, name)
        torch.cuda.synchronize()
        reset_launches()
        img, st = render_to_files(scene, base, seed=SEED, device=dev)
        torch.cuda.synchronize()
        n = read_launches()
        for ext in (".exr", ".png"):
            if os.path.getsize(base + ext) == 0:
                raise AssertionError(f"{name}: empty {ext} output")
    mean = float(img.mean())
    log(f"{name} {AJAX_SIZE}x{AJAX_SIZE} spp {st['spp']} "
        f"({integrator}): {st['seconds']:.2f} s, rays {st['rays']}, "
        f"{st['mrays_per_sec']:.3f} Mrays/s, "
        f"{st['samples_per_sec']:.1f} samples/s, mean radiance "
        f"{mean:.4f} (expected {band}); launches {n}")
    if img.shape != (AJAX_SIZE, AJAX_SIZE, 3):
        raise AssertionError(f"{name}: image shape {img.shape}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite values")
    if band is not None and not band[0] <= mean <= band[1]:
        raise AssertionError(f"{name}: mean radiance {mean} outside {band}")
    if integrator == "normals" and st["rays"] != AJAX_SIZE ** 2 * spp:
        raise AssertionError(f"{name}: {st['rays']} rays, expected "
                             f"{AJAX_SIZE ** 2 * spp}")
    need = ["entry_min", sweep_kernel] + (
        ["lane_keys"] if integrator == "whitted" else [])
    for k in need:
        if n[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if n["resident_sweep"] != 0:
        raise AssertionError(f"{name}: the resident sweep ran on a "
                             "streamed scene")
    return img, st, n


def ajax_full_renders(dev) -> dict:
    """ajax_normals and ajax_rough at full size through render_to_files;
    returns {render name: {kernel name: launches}}."""
    return {name: ajax_render(dev, name, *spec)[2]
            for name, spec in AJAX_FULL.items()}


def ajax_cull_renders(dev) -> dict:
    """ajax_normals on the Moller-Trumbore operand, uncut and then with
    sub-slab culling (config.STREAM_CULL_T = CULL_T): the culled image
    passes the exact gate against the uncut one, with equal rays, and
    sweeps with K5-cull only.  Returns the culled render's launches."""
    integrator, spp, band = AJAX_FULL["ajax_normals"]
    with switches(USE_BW_SWEEP=False):
        img_u, st_u, _ = ajax_render(dev, "ajax_normals mt uncut",
                                     integrator, spp, band)
        with switches(STREAM_CULL_T=CULL_T):
            img_c, st_c, n = ajax_render(dev, "ajax_normals mt culled",
                                         integrator, spp, band,
                                         "stream_sweep_culled")
    if n["stream_sweep"]:
        raise AssertionError("the culled render launched K5 uncut")
    gate("ajax_normals culled vs uncut", img_c, st_c, img_u, st_u,
         ("culled", "uncut"))
    return dict(launches=n, seconds=st_c["seconds"],
                uncut_seconds=st_u["seconds"])


# ---------------------------------------------------------------------------
# checkpoint/resume, the statistical harness, the scan and BVH backends
# ---------------------------------------------------------------------------

def checkpointed_renders(dev) -> dict:
    """The full living-room render (FULL) in CKPT_CHUNKS chunks: A uncut;
    B with a checkpoint, a preview, on_chunk and max_chunks=2, which must
    stop half way with the checkpoint on disk; C the same call without
    max_chunks, which must resume, finish, remove the checkpoint and give
    A's image (SHA-1) and rays.  Returns the launches of B and C together
    (the checkpointed render) and the seconds of each."""
    import hashlib

    import torch
    from nori_tpu_torch.scenes_builtin import living_room
    from nori_tpu_torch.wavefront import render_wavefront

    cfg = FULL
    total_q = cfg["width"] * cfg["height"] * cfg["spp"]
    chunk = total_q // CKPT_CHUNKS
    kw = dict(seed=SEED, n_lanes=cfg["n_lanes"], chunk=chunk, device=dev)

    def render(**extra):
        scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                            detail=cfg["detail"])
        img, st = render_wavefront(scene, **kw, **extra)
        torch.cuda.synchronize()
        return img, st, hashlib.sha1(img.tobytes()).hexdigest()

    _, st_a, sha_a = render()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "living_room.ckpt")
        pv = os.path.join(tmp, "living_room_preview.png")
        fracs = []
        extra = dict(checkpoint_path=ck, preview_path=pv,
                     on_chunk=lambda img, f: fracs.append(f))
        reset_launches()
        _, st_b, _ = render(max_chunks=2, **extra)
        if st_b["done"] or not os.path.exists(ck) or fracs != [0.25, 0.5]:
            raise AssertionError(
                f"cut render: done {st_b['done']}, checkpoint "
                f"{os.path.exists(ck)}, fractions {fracs}")
        png_bytes = os.path.getsize(pv)
        _, st_c, sha_c = render(**extra)
        launches = read_launches()
        if not st_c["done"] or os.path.exists(ck) or fracs[2:] != [0.75, 1.0]:
            raise AssertionError(
                f"resumed render: done {st_c['done']}, checkpoint "
                f"{os.path.exists(ck)}, fractions {fracs}")
    log(f"checkpointed render {cfg['width']}x{cfg['height']} spp "
        f"{cfg['spp']}, {CKPT_CHUNKS} chunks of {chunk}: uncut "
        f"{st_a['seconds']:.2f} s; cut after 2 chunks {st_b['seconds']:.2f} s "
        f"(rays {st_b['rays']}), resumed {st_c['seconds']:.2f} s; preview "
        f"PNG {png_bytes} bytes; rays {st_c['rays']} vs {st_a['rays']}; "
        f"SHA-1 {sha_c} vs {sha_a}")
    log(f"  launches {launches}")
    if sha_c != sha_a or st_c["rays"] != st_a["rays"]:
        raise AssertionError("the resumed render differs from the uncut one")
    for name in ("entry_min", "resident_sweep", "lane_keys"):
        if launches[name] <= 0:
            raise AssertionError(f"checkpointed render: {name} never launched")
    return dict(launches=launches, uncut_seconds=st_a["seconds"],
                cut_seconds=st_b["seconds"], resumed_seconds=st_c["seconds"],
                preview_bytes=png_bytes, sha1=sha_a, rays=st_a["rays"])


# ---------------------------------------------------------------------------
# the sharded drivers (nori_tpu_torch.parallel) and the sweep report
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def nccl_rank(dev):
    """This process as the one rank of an nccl group, for a block."""
    import torch.distributed as dist
    from nori_tpu_torch.parallel import make_group

    with tempfile.TemporaryDirectory() as tmp:
        _, _, _, dev = make_group("nccl", dev,
                                  "file://" + os.path.join(tmp, "rdzv"), 0, 1)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def sharded_run(dev, label: str, ranks: int, scene_fn, scene_kwargs,
                driver: str, kwargs) -> tuple:
    """One render through a sharded driver: one nccl rank in this process
    (ranks 1), or `ranks` gloo ranks spawned on `dev` (they share the
    card).  Returns (image, stats, launches of each rank); each rank
    reads its own launch counts, since the counts are per process."""
    from nori_tpu_torch import parallel

    jobs = [(scene_fn, scene_kwargs, driver, kwargs)]
    if ranks == 1:
        with nccl_rank(dev) as rank_dev:
            (img, st, launches), = parallel.render_jobs(rank_dev, jobs)
    else:
        (img, st, launches), = parallel.spawn(
            parallel.render_jobs, ranks, jobs, backend="gloo",
            device=str(dev), timeout=600)
    log(f"{label}: {ranks} rank(s) ({'nccl' if ranks == 1 else 'gloo'}), "
        f"{st['seconds']:.2f} s, rays {st['rays']}, "
        f"{st['mrays_per_sec']:.3f} Mrays/s"
        + (f", rays per rank {st['rays_per_dev']}, steps {st['steps']}, "
           f"wide steps {st['wide_steps']}" if "steps" in st else ""))
    for r, n in enumerate(launches):
        log(f"  rank {r} launches {n}")
    return img, st, launches


def summed(launches: list) -> dict:
    return {k: sum(n[k] for n in launches) for k in launches[0]}


def sharded_living_room(dev, ckpt: dict) -> dict:
    """FULL through render_sharded_wavefront at FULL's lanes per rank and
    checkpointed_renders' chunk (total_q / CKPT_CHUNKS) per rank, at one
    nccl rank and at two gloo ranks on the one card: each must give the
    uncut checkpointed image's SHA-1 and rays, and launch K1, K2 and K3
    on every rank.  Returns {ranks: stats and launches}."""
    import hashlib

    from nori_tpu_torch.scenes_builtin import living_room

    cfg = FULL
    total_q = cfg["width"] * cfg["height"] * cfg["spp"]
    scene_kw = dict(width=cfg["width"], height=cfg["height"],
                    spp=cfg["spp"], detail=cfg["detail"])
    kw = dict(seed=SEED, n_lanes_dev=cfg["n_lanes"],
              chunk_dev=total_q // CKPT_CHUNKS)
    out = {}
    for ranks in SHARDED_RANKS:
        img, st, launches = sharded_run(
            dev, "sharded living room", ranks, living_room, scene_kw,
            "wavefront", kw)
        sha = hashlib.sha1(img.tobytes()).hexdigest()
        log(f"  SHA-1 {sha} vs {ckpt['sha1']}; rays {st['rays']} vs "
            f"{ckpt['rays']}")
        if sha != ckpt["sha1"] or st["rays"] != ckpt["rays"]:
            raise AssertionError(f"sharded living room at {ranks} rank(s) "
                                 "differs from the uncut render")
        for r, n in enumerate(launches):
            for k in ("entry_min", "resident_sweep", "lane_keys"):
                if n[k] <= 0:
                    raise AssertionError(f"sharded living room: rank {r} "
                                         f"never launched {k}")
        out[ranks] = dict(seconds=st["seconds"],
                          mrays_per_sec=st["mrays_per_sec"],
                          rays_per_dev=st["rays_per_dev"], steps=st["steps"],
                          wide_steps=st["wide_steps"], launches=launches)
    return out


def sharded_ajax(dev) -> dict:
    """ajax_normals through render_sharded at one nccl rank and at two
    gloo ranks on the one card, against the single-device batch driver
    at the same batch: equal rays and the same image bits (rank 0 splats
    the ranks' shares of each batch as one batch); every rank launches
    K5 and never K2.  Returns {ranks: stats and launches}."""
    import numpy as np
    import torch
    from nori_tpu_torch.render import render

    integrator, spp, band = AJAX_FULL["ajax_normals"]
    scene_kw = dict(width=AJAX_SIZE, height=AJAX_SIZE, spp=spp,
                    integrator=integrator)
    ref, ref_st = render(ajax_scene(**scene_kw), seed=SEED, device=dev)
    torch.cuda.synchronize()
    out = {"single_device_seconds": ref_st["seconds"]}
    for ranks in SHARDED_RANKS:
        img, st, launches = sharded_run(
            dev, "sharded ajax_normals", ranks, ajax_scene, scene_kw,
            "batch", dict(seed=SEED))
        gate(f"sharded ajax_normals, {ranks} rank(s)", img, st, ref, ref_st,
             ("sharded", "single device"))
        if not np.array_equal(img, ref):
            raise AssertionError(f"sharded ajax_normals at {ranks} rank(s) "
                                 "is not the single-device image")
        for r, n in enumerate(launches):
            if n["stream_sweep"] <= 0 or n["resident_sweep"] != 0:
                raise AssertionError(f"sharded ajax_normals: rank {r} "
                                     f"launches {n}")
        out[ranks] = dict(seconds=st["seconds"],
                          mrays_per_sec=st["mrays_per_sec"],
                          launches=launches)
    return out


def multicard_dry_run(dev) -> dict:
    """nori_tpu_torch.scripts.multicard's dry-run phase at MULTICARD_RANKS
    gloo ranks sharing `dev` (it raises on a failed check, and on a rank
    that launched none of K1 and K2 in the living room); returns its
    record."""
    from nori_tpu_torch.scripts import multicard

    rec = multicard.dry_run(MULTICARD_RANKS, "gloo", str(dev))
    for r, n in enumerate(rec["living_room"]["launches"]):
        log(f"  rank {r} launches {n}")
    return rec


def room_kernel_report(dev) -> dict:
    """profiling.kernel_report on FULL's scene at CHECK_LANES rays after
    8 wavefront steps; returns the report and its launches."""
    import math

    import torch
    from nori_tpu_torch.profiling import kernel_report
    from nori_tpu_torch.scenes_builtin import living_room

    scene = living_room(FULL["width"], FULL["height"], FULL["spp"],
                        detail=FULL["detail"])
    torch.cuda.synchronize()
    reset_launches()
    rep = kernel_report(scene, n_rays=CHECK_LANES, seed=SEED,
                        bounce_steps=8, device=dev)
    launches = read_launches()
    log(f"kernel report: {json.dumps(rep)}")
    log(f"  launches {launches}")
    for k, v in rep.items():
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"kernel report: {k} = {v}")
    for k in ("entry_min", "resident_sweep"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel report: {k} never launched")
    return dict(report=rep, launches=launches)


def write_furnace(directory: str) -> str:
    """A closed cube [-1, 1]^3 with every face's geometric normal inward
    (the camera sits at its centre); returns the OBJ's path."""
    import numpy as np

    corners = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    lines = [f"v {x} {y} {z}" for x, y, z in corners]
    for axis in range(3):
        for side in (-1, 1):
            o = [i for i in range(3) if i != axis]
            quad = []
            for a, b in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
                p = [0, 0, 0]
                p[axis], p[o[0]], p[o[1]] = side, a, b
                quad.append(corners.index(tuple(p)) + 1)
            p0, p1, p2 = (np.asarray(corners[i - 1]) for i in quad[:3])
            if np.cross(p1 - p0, p2 - p0)[axis] * side > 0:
                quad.reverse()
            lines += [f"f {quad[0]} {quad[1]} {quad[2]}",
                      f"f {quad[0]} {quad[2]} {quad[3]}"]
    path = os.path.join(directory, "furnace.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def furnace_xml(integrators, references, samples: int | None = None) -> str:
    """A scene-mode t-test of `samples` camera rays per scene (None: the
    plugin's default): one furnace (albedo 0.5, radiance 1, the OBJ of
    write_furnace beside the XML) per integrator."""
    scenes = "".join(f"""
  <scene>
    <integrator type="{integ}"/>
    <camera type="perspective">
      <float name="fov" value="10"/>
      <integer name="width" value="1"/>
      <integer name="height" value="1"/>
    </camera>
    <mesh type="obj">
      <string name="filename" value="furnace.obj"/>
      <bsdf type="diffuse"><color name="albedo" value="0.5, 0.5, 0.5"/></bsdf>
      <emitter type="area"><color name="radiance" value="1, 1, 1"/></emitter>
    </mesh>
  </scene>""" for integ in integrators)
    refs = ", ".join(str(r) for r in references)
    count = ("" if samples is None else
             f'\n  <integer name="sampleCount" value="{samples}"/>')
    return (f'<test type="ttest">\n  <string name="references" '
            f'value="{refs}"/>{count}{scenes}\n</test>\n')


def run_cli(tmp: str, name: str, xml: str) -> tuple[int, float]:
    """`python -m nori_tpu_torch <name>.xml --device cuda` in-process on
    the XML written to tmp; returns (exit code, seconds)."""
    from nori_tpu_torch.main import main as cli

    path = os.path.join(tmp, name + ".xml")
    with open(path, "w") as f:
        f.write(xml)
    t0 = time.time()
    code = cli([path, "--device", "cuda"])
    dt = time.time() - t0
    log(f"{name}: exit {code}, {dt:.2f} s")
    return code, dt


def ttest_microfacet_xml() -> str:
    """The microfacet BSDF t-test of ttest-microfacet.xml, transcribed:
    TTEST_ANGLES against TTEST_REFERENCES."""
    refs = ", ".join(str(r) for r in TTEST_REFERENCES)
    angles = ", ".join(str(a) for a in TTEST_ANGLES)
    return f"""<test type="ttest">
  <string name="angles" value="{angles}"/>
  <string name="references" value="{refs}"/>
  <bsdf type="microfacet">
    <float name="alpha" value="0.1"/>
    <float name="intIOR" value="1.5"/>
    <float name="extIOR" value="1.000277"/>
    <color name="kd" value="0.1, 0.2, 0.15"/>
  </bsdf>
</test>
"""


def chi2_xml() -> str:
    """chi2test over diffuse and microfacet at CHI2_ALPHAS, the plugin's
    defaults otherwise (5 tests each)."""
    bsdfs = "".join(f'\n  <bsdf type="microfacet"><float name="alpha" '
                    f'value="{a}"/></bsdf>' for a in CHI2_ALPHAS)
    return (f'<test type="chi2test">\n  <boolean name="dumpFiles" '
            f'value="false"/>\n  <bsdf type="diffuse"/>{bsdfs}\n</test>\n')


def harness_ttests() -> dict:
    """The t-test suites through the CLI's test root: the microfacet BSDF
    means of ttest-microfacet.xml, the furnace for path_mats, path_ems,
    path_mis (Li = 1 / (1 - 0.5) = 2) and whitted (1 + 0.5), each of which
    must pass, and the path_mis furnace held to 2.2, which must fail.
    Returns the furnace suite's launches and each suite's seconds."""
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_furnace(tmp)
        code, seconds["ttest-microfacet"] = run_cli(tmp, "ttest-microfacet",
                                                    ttest_microfacet_xml())
        if code != 0:
            raise AssertionError("the microfacet t-test failed")
        reset_launches()
        code, seconds["ttest-furnace"] = run_cli(tmp, "ttest-furnace",
                                                 furnace_xml(*zip(*FURNACE)))
        launches = read_launches()
        if code != 0:
            raise AssertionError("a furnace t-test failed")
        code, seconds["ttest-furnace-wrong"] = run_cli(
            tmp, "ttest-furnace-wrong", furnace_xml(["path_mis"], [2.2]))
        if code != 1:
            raise AssertionError("the furnace held to 2.2 did not fail")
    log(f"  furnace launches {launches}")
    return dict(launches=launches, seconds=seconds)


def harness_chi2_warps() -> dict:
    """chi2test over diffuse and microfacet alpha 0.1, 0.5 and 1.0 at the
    plugin's defaults (resolution 10, 5 tests, 1,000,000 samples each)
    through the CLI, and warptest on every warp and the microfacet BRDF;
    all must pass.  Returns the seconds of each."""
    from nori_tpu_torch import warp, warptest

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        code, seconds["chi2test"] = run_cli(tmp, "chi2test", chi2_xml())
    if code != 0:
        raise AssertionError("a chi^2 test failed")
    for name in [*warp.WARPS, "microfacet"]:
        t0 = time.time()
        ok, _, _ = warptest.run_warp_test(name, device="cuda")
        seconds[f"warptest {name}"] = time.time() - t0
        if not ok:
            raise AssertionError(f"warptest {name} failed")
    log(f"  warptest seconds {seconds}")
    return seconds


def ref_gates_runner(card: str) -> dict:
    """nori_tpu_torch.scripts.ref_gates's main at --scale REF_GATES_SCALE
    on the card over a temporary root holding the microfacet t-test, the
    furnace and the chi^2 suite of the harness phases, each named as
    this script's own: every XML must pass with the tests it holds, and
    the furnace scenes must launch K1 and K2.  Returns the record and
    its launches."""
    from nori_tpu_torch.scripts import ref_gates

    # name: (XML, the tests it holds)
    suites = {"smoke-ttest-microfacet.xml":
              (ttest_microfacet_xml(), len(TTEST_ANGLES)),
              "smoke-furnace.xml": (furnace_xml(*zip(*FURNACE)),
                                    len(FURNACE)),
              "smoke-chi2test-microfacet.xml":
              (chi2_xml(), 5 * (1 + len(CHI2_ALPHAS)))}
    with tempfile.TemporaryDirectory() as tmp:
        write_furnace(tmp)
        for name, (xml, _) in suites.items():
            with open(os.path.join(tmp, name), "w") as f:
                f.write(xml)
        out = os.path.join(tmp, "ref_gates.json")
        t0 = time.time()
        reset_launches()
        code = ref_gates.main([out, "--root", tmp, "--scale",
                               str(REF_GATES_SCALE)], fixtures=tuple(suites))
        launches = read_launches()
        seconds = time.time() - t0
        with open(out) as f:
            rec = json.load(f)
    log(f"ref-gates runner at --scale {REF_GATES_SCALE}: exit {code}, "
        f"{seconds:.1f} s on {card}; launches {launches}")
    for name, (_, total) in suites.items():
        r = rec["fixtures"][name]
        if not (r.get("ok") and r["passed"] == r["total"] == total):
            raise AssertionError(f"ref-gates runner: {name}: {r}, expected "
                                 f"{total}/{total}")
    if code != 0 or not rec["all_ok"]:
        raise AssertionError(f"ref-gates runner: exit {code}, {rec}")
    for name in ("entry_min", "resident_sweep"):
        if launches[name] <= 0:
            raise AssertionError(f"ref-gates runner: {name} never launched")
    rec["seconds"] = seconds
    return dict(record=rec, launches=launches)


#: the backends compared on the check rays: (label, accel_mode, switches)
BACKENDS = (("scan", "scan", {}), ("bvh", "bvh", {}),
            ("sweeps mt", "pallas", {"USE_BW_SWEEP": False}),
            ("sweeps", "pallas", {}))


def on_boundary(hit, mint, maxt, tol):
    """Hits within tol of mint, within max(tol, 1e-3 maxt) of maxt, or
    within 1e-4 of a triangle edge in barycentric terms: where two
    implementations of one triangle test, rounding in other orders, may
    answer differently.  (A shadow ray stops 1e-4 of its length short of
    its point on the light, integrators.base.shadow_ray_args, and where
    it grazes the light, t moves by more than that.)"""
    import torch

    near_end = (((hit.t - mint).abs() <= tol)
                | ((hit.t - maxt).abs() <= torch.maximum(tol, 1e-3 * maxt)))
    w = 1.0 - hit.u - hit.v
    edge = torch.minimum(torch.minimum(hit.u, hit.v), w) < 1e-4
    return hit.valid & (near_end | edge)


def backend_queries(sd, rays, shadow) -> dict:
    """Closest and any-hit queries on the check rays under each of
    BACKENDS, held to the scan's answers: bvh (the scan's arithmetic)
    gives the same hit sets and any-hit answers; the sweeps, on the
    Moller-Trumbore operand (a kernel rounding in its own order) and on
    the Baldwin-Weber operand (the default: a different test, whose t
    moves by ~1e-5 where a ray leaves a surface), the same but on rays
    where either backend's nearest surface, or the scan's in the
    interval widened as on_boundary allows, is on_boundary; both t
    within tol = 1e-6 (t + max|o|) (the error of t scales with the
    coordinates) and another triangle only at the same t (a shared edge,
    or a coplanar triangle the walk reached first).  Differences on
    boundary rays are counted.  Each backend's ms per query.  Returns
    {label: ms and counts}."""
    import torch
    from nori_tpu_torch.accel import traverse

    def args(r):
        return r[0:3].T.contiguous(), r[3:6].T.contiguous(), r[6], r[7]

    queries = {"closest": args(rays), "shadow": args(shadow)}
    out, hits, occ = {}, {}, {}
    for label, mode, extra in BACKENDS:
        with switches(accel_mode=mode, **extra):
            hits[label] = {q: traverse.intersect(sd, *a)
                           for q, a in queries.items()}
            occ[label] = traverse.occluded(sd, *queries["shadow"])
            torch.cuda.synchronize()
            out[label] = dict(
                closest_ms=time_ms(
                    lambda: traverse.intersect(sd, *queries["closest"]), 1),
                any_hit_ms=time_ms(
                    lambda: traverse.occluded(sd, *queries["shadow"]), 1))
        log(f"backend {label}: closest {out[label]['closest_ms']:.3f} ms, "
            f"any hit {out[label]['any_hit_ms']:.3f} ms on "
            f"{rays.shape[1]} rays; {int(hits[label]['closest'].valid.sum())} "
            f"hits, {int(occ[label].sum())} occluded")
    tol, near = {}, {}
    for q, (o, d, mint, maxt) in queries.items():
        # t's rounding error scales with the coordinates (o - v0), not t
        tol[q] = 1e-6 * (maxt.abs().clamp_max(1e6) + o.abs().amax(dim=1))
        with switches(accel_mode="scan"):
            near[q] = traverse.intersect(
                sd, o, d, mint - tol[q],
                maxt + torch.maximum(tol[q], 1e-3 * maxt))
    for label, _, _ in BACKENDS[1:]:
        edge = {q: on_boundary(near[q], a[2], a[3], tol[q])
                | on_boundary(hits[label][q], a[2], a[3], tol[q])
                for q, a in queries.items()}
        h, ref = hits[label]["closest"], hits["scan"]["closest"]
        both = h.valid & ref.valid
        far = ((h.t - ref.t).abs() > tol["closest"]) & both
        mask = h.valid != ref.valid
        flips = occ[label] != occ["scan"]
        counts = dict(hit_mask=int(mask.sum()), any_hit=int(flips.sum()),
                      t_off=int(far.sum()), other_triangle_same_t=int(
                          ((h.tri != ref.tri) & both & ~far).sum()))
        bad = (mask | far) & ~edge["closest"]
        counts["off_boundary"] = dict(
            closest=int(bad.sum()),
            any_hit=int((flips & ~edge["shadow"]).sum()))
        log(f"{label} vs scan: {counts}")
        out[label].update(counts)
        if label == "bvh" and (counts["hit_mask"] or counts["any_hit"]
                               or counts["t_off"]):
            raise AssertionError("bvh: answers differ from the scan's")
        for q, rows in (("closest", bad), ("shadow", flips & ~edge["shadow"])):
            hq, rq, nq = hits[label][q], hits["scan"][q], near[q]
            for i in torch.nonzero(rows).flatten()[:8].tolist():
                o, d, mint, maxt = (a[i] for a in queries[q])
                log(f"  {q} ray {i}: mint {float(mint)} maxt {float(maxt)}; "
                    f"{label} t {float(hq.t[i])} tri {int(hq.tri[i])} uv "
                    f"{float(hq.u[i])} {float(hq.v[i])}; scan t "
                    f"{float(rq.t[i])} tri {int(rq.tri[i])}; nearest t "
                    f"{float(nq.t[i])} tri {int(nq.tri[i])} uv "
                    f"{float(nq.u[i])} {float(nq.v[i])}")
        if any(counts["off_boundary"].values()):
            raise AssertionError(f"{label}: answers differ from the scan's "
                                 "off boundary hits")
    return out


def bvh_parity_render(dev):
    """The PARITY render under accel_mode bvh against the sweeps' render,
    both on the card, by `gate`; returns its launches and seconds."""
    from nori_tpu_torch.scenes_builtin import living_room
    from nori_tpu_torch.wavefront import render_wavefront

    cfg = PARITY
    out = {}
    for mode in ("pallas", "bvh"):
        with switches(accel_mode=mode):
            scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                                detail=cfg["detail"])
            out[mode] = render_wavefront(scene, seed=SEED,
                                         n_lanes=cfg["n_lanes"], device=dev)
    (img_b, st_b), (img_s, st_s) = out["bvh"], out["pallas"]
    gate(f"bvh parity render {cfg['width']}x{cfg['height']} spp {cfg['spp']}",
         img_b, st_b, img_s, st_s, ("bvh", "sweeps"))
    return dict(bvh_seconds=st_b["seconds"], sweeps_seconds=st_s["seconds"])


# ---------------------------------------------------------------------------
# the path-graph pipeline (nori_tpu_torch.pathgraph)
# ---------------------------------------------------------------------------

def pg_images(k: int) -> tuple:
    """The seven images pg.write_outputs writes, as suffixes of a base."""
    return (f"_k-{k}_direct.exr", f"_k-{k}_direct_o.exr", "_Le_init.exr",
            f"_k-{k}_full.exr", f"_k-{k}_indirect.exr",
            f"_k-{k}_indirect_pt.exr", f"_k-{k}_indirect_blur.exr")


def image_gate(label: str, a, b):
    """tests/test_torch_render.py's image gate: RMSE < 1e-3, < 1% of
    pixels off by more than 1e-3, max |diff| < 5e-3."""
    import numpy as np

    diff = np.abs(a - b)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    off = float(np.mean(diff.max(axis=-1) > 1e-3))
    worst = float(diff.max())
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"{label}: shape {a.shape} or non-finite")
    if not (rmse < 1e-3 and off < 0.01 and worst < 5e-3):
        raise AssertionError(
            f"{label}: rmse {rmse:.3e}, pixels off {off:.4f}, max |diff| "
            f"{worst:.3e} fail the image gate")
    return rmse, off, worst


def compare_dumps(a, b) -> int:
    """Integer fields of two dumps of one scene: every path's point
    count, and on the paths whose counts agree, the first-point
    offsets' layout, each point's continuation (nidx) and BSDF class.
    Returns the paths whose counts differ."""
    import numpy as np

    ca = a.paths["numOfPathPoints"].astype(np.int64)
    cb = b.paths["numOfPathPoints"].astype(np.int64)
    for g, c in ((a, ca), (b, cb)):
        first = g.paths["firstPathPointIdx"].astype(np.int64)
        if not np.array_equal(first, np.cumsum(c) - c):
            raise AssertionError("firstPathPointIdx is not the count prefix")
    same = ca == cb
    sel_a = np.repeat(same, ca)
    sel_b = np.repeat(same, cb)
    if not np.array_equal(a.sps["bsdf_type"][sel_a],
                          b.sps["bsdf_type"][sel_b]):
        raise AssertionError("dump field bsdf_type differs")
    nxt_a = a.sps["nidx"][sel_a] > 0
    nxt_b = b.sps["nidx"][sel_b] > 0
    rel_a = a.sps["nidx"][sel_a][nxt_a] - np.nonzero(sel_a)[0][nxt_a]
    rel_b = b.sps["nidx"][sel_b][nxt_b] - np.nonzero(sel_b)[0][nxt_b]
    if not (np.array_equal(nxt_a, nxt_b) and (rel_a == 1).all()
            and (rel_b == 1).all()):
        raise AssertionError("dump field nidx differs")
    return int((~same).sum())


def pathgraph_parity(dev) -> dict:
    """PG_PARITY: the port's dump and every pg mode on the card against
    the same on the CPU: the dumps' integer fields (compare_dumps) and
    the seven images of each mode (image_gate).  Returns the launches,
    the paths whose point count differs and the seconds."""
    import torch
    from nori_tpu_torch.bitmap import read_exr
    from nori_tpu_torch.pathgraph import pg
    from nori_tpu_torch.pathgraph.dump import trace_dump
    from nori_tpu_torch.pathgraph.io import save_path_graph
    from nori_tpu_torch.scenes_builtin import cornell_box

    cfg = PG_PARITY
    k = cfg["k"]
    devices = (("card", dev), ("cpu", torch.device("cpu")))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_launches()
        dumps = {}
        for name, d in devices:
            scene = cornell_box(cfg["width"], cfg["height"], spp=1,
                                sphere_subdiv=cfg["sphere_subdiv"])
            t0 = time.time()
            g = trace_dump(scene, max_depth=cfg["max_depth"], seed=SEED,
                           batch=cfg["batch"], device=d)
            seconds[f"dump {name}"] = time.time() - t0
            base = os.path.join(tmp, name, "cbox")
            os.makedirs(os.path.dirname(base))
            save_path_graph(base, g)
            dumps[name] = (base, g)
        changed = compare_dumps(dumps["card"][1], dumps["cpu"][1])
        log(f"pathgraph parity {cfg['width']}x{cfg['height']}, depth "
            f"{cfg['max_depth']}: {dumps['card'][1].num_points} (card) vs "
            f"{dumps['cpu'][1].num_points} (cpu) shading points, {changed} "
            f"of {len(dumps['card'][1].paths)} paths with another point "
            f"count")
        worst = 0.0
        for mode in PG_MODES:
            for name, d in devices:
                t0 = time.time()
                # "l" loads the clusters the "opt" run saved
                pg.run(dumps[name][0], k=k, iterations=cfg["iterations"],
                       mode=mode, save_dump=mode == "opt", verbose=False,
                       device=d)
                seconds[f"{mode} {name}"] = time.time() - t0
            for suffix in pg_images(k):
                _, _, w = image_gate(f"pathgraph parity {mode} {suffix}",
                                     read_exr(dumps["card"][0] + suffix),
                                     read_exr(dumps["cpu"][0] + suffix))
                worst = max(worst, w)
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"  7 images x {len(PG_MODES)} modes pass the image gate (max "
        f"|diff| {worst:.3e}); seconds " + ", ".join(
            f"{name} {sec:.2f}" for name, sec in seconds.items()))
    log(f"  launches {launches}")
    for name in ("entry_min", "resident_sweep"):
        if launches[name] <= 0:
            raise AssertionError(f"pathgraph parity: {name} never launched")
    return dict(launches=launches, paths_changed=changed, seconds=seconds,
                max_abs=worst)


def pathgraph_protocol(dev) -> dict:
    """PG_PROTOCOL: one full-size dump of the living room, then pg in
    mode opt and in mode knn on it, with the seconds of every stage and
    the peak device memory.  Returns the launches and the numbers."""
    import numpy as np
    import torch
    from nori_tpu_torch.bitmap import read_exr
    from nori_tpu_torch.pathgraph import pg
    from nori_tpu_torch.pathgraph.dump import trace_dump
    from nori_tpu_torch.pathgraph.io import save_path_graph
    from nori_tpu_torch.scenes_builtin import living_room

    cfg = PG_PROTOCOL
    k, iters = cfg["k"], cfg["iterations"]
    scene = living_room(cfg["width"], cfg["height"], spp=1,
                        detail=cfg["detail"])
    out = {"modes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        g = trace_dump(scene, max_depth=cfg["max_depth"], seed=SEED,
                       device=dev)
        torch.cuda.synchronize()
        out["dump_seconds"] = time.time() - t0
        out["dump_peak_bytes"] = torch.cuda.max_memory_allocated()
        base = os.path.join(tmp, "living_room")
        t0 = time.time()
        save_path_graph(base, g)
        out["save_seconds"] = time.time() - t0
        lem = np.asarray(g.lps["L_em"], np.float32)
        pt_img, _ = pg._splat_first_hits(g, np.asarray(g.sps["eLi"]) + lem)
        out.update(points=g.num_points, paths=len(g.paths),
                   pt_mean=float(pt_img.mean()))
        log(f"pathgraph protocol: living room {cfg['width']}x{cfg['height']} "
            f"detail {cfg['detail']}, depth {cfg['max_depth']}: "
            f"{g.num_points} shading points, {len(g.paths)} paths; dump "
            f"{out['dump_seconds']:.2f} s (peak "
            f"{out['dump_peak_bytes'] / 2**30:.2f} GiB), saved in "
            f"{out['save_seconds']:.2f} s; the dump's PT image mean "
            f"{out['pt_mean']:.4f} (expected {MEAN_RANGE})")
        del g
        for mode in ("opt", "knn"):
            torch.cuda.reset_peak_memory_stats()
            times = {}
            t0 = time.time()
            _, blur, mc, direct = pg.run(base, k=k, iterations=iters,
                                         mode=mode, device=dev, times=times)
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            finite = all(bool(torch.isfinite(t).all())
                         for t in blur + mc + [direct])
            means = {}
            for suffix in pg_images(k):
                img = read_exr(base + suffix)
                if not np.isfinite(img).all():
                    raise AssertionError(f"protocol {mode}: {suffix} holds "
                                         "non-finite values")
                means[suffix] = float(img.mean())
            full = means[f"_k-{k}_full.exr"]
            log(f"  mode {mode}, k {k}, {iters} iterations: {wall:.2f} s, "
                f"peak device memory {peak / 2**30:.2f} GiB; full image "
                f"mean {full:.4f} (expected {MEAN_RANGE})")
            log("    stages (s): " + ", ".join(
                f"{name} {sec:.3f}" for name, sec in times.items()))
            if not finite:
                raise AssertionError(f"protocol {mode}: non-finite results")
            if not MEAN_RANGE[0] <= full <= MEAN_RANGE[1]:
                raise AssertionError(
                    f"protocol {mode}: full image mean {full} outside "
                    f"{MEAN_RANGE}")
            out["modes"][mode] = dict(seconds=wall, stages=times,
                                      peak_bytes=peak, means=means)
        torch.cuda.synchronize()
        out["launches"] = read_launches()
    log(f"  launches {out['launches']}")
    if not MEAN_RANGE[0] <= out["pt_mean"] <= MEAN_RANGE[1]:
        raise AssertionError(f"protocol: the dump's PT image mean "
                             f"{out['pt_mean']} outside {MEAN_RANGE}")
    for name in ("entry_min", "resident_sweep"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"protocol: {name} never launched")
    if out["launches"]["stream_sweep"] != 0:
        raise AssertionError("protocol: the resident living room ran K5")
    return out


# ---------------------------------------------------------------------------
# the measurement and evaluation entry points
# ---------------------------------------------------------------------------

def bench_phase() -> dict:
    """`python bench_torch.py` in a subprocess with BENCH_TIME_BUDGET =
    BENCH_BUDGET_S: its last line a complete record (not partial, or
    its skips listed), the living_room and ajax_rough rows present,
    each row's two image SHA-1s equal and its rays > 0, each row of
    BENCH_KERNELS launching its kernels, and the living room's kernel
    report present (or listed as skipped), with no error and every
    figure finite and > 0.  Returns the record."""
    import math

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, BENCH_TIME_BUDGET=str(BENCH_BUDGET_S))
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=BENCH_BUDGET_S + 180)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench_torch.py exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    log(f"bench: {len(lines)} records, the last after {rec['elapsed_s']:.1f} "
        f"s of {rec['budget_s']:.0f}; device {rec['device']}; skipped "
        f"{rec.get('skipped', [])}")
    if rec.get("partial") and not rec.get("skipped"):
        raise AssertionError("bench: partial record with no skips listed")
    for name in BENCH_KERNELS:
        if name not in rec["breakdown"]:
            raise AssertionError(f"bench: no {name} row")
    for name, row in rec["breakdown"].items():
        if "error" in row:
            raise AssertionError(f"bench: row {name} failed: {row['error']}")
        log(f"  {name} ({row['driver']}, {row['spp']} spp, "
            f"{row['triangles']} triangles): seconds {row['seconds_each']}, "
            f"Mrays/s {row['mrays_per_sec_each']}, rays {row['rays_each']}, "
            f"occupancy {row['occupancy']:.4f}, steps {row['steps']}, mean "
            f"{row['mean_radiance']:.4f}, row {row['row_seconds']:.1f} s; "
            f"sha1 {row['sha1'][0][:12]} {row['sha1'][1][:12]}; launches "
            f"{row['launches']}")
        if row["sha1"][0] != row["sha1"][1]:
            raise AssertionError(f"bench: {name}'s two images differ")
        if min(row["rays_each"]) <= 0:
            raise AssertionError(f"bench: {name} traced no ray")
        for k in BENCH_KERNELS.get(name, ()):
            if row["launches"][k] <= 0:
                raise AssertionError(f"bench: {name} never launched {k}")
    report = rec["kernel"].get("living_room")
    if report is None:
        if not any(s["row"] == "kernel_living_room"
                   for s in rec.get("skipped", ())):
            raise AssertionError("bench: no kernel report, and none skipped")
    else:
        log(f"  kernel report: {report}")
        if "error" in report:
            raise AssertionError(f"bench: kernel report failed: "
                                 f"{report['error']}")
        for k, v in report.items():
            if not (math.isfinite(v) and v > 0):
                raise AssertionError(f"bench: kernel report: {k} = {v}")
    return rec


def rmse_gate_phase(dev) -> dict:
    """nori_tpu_torch.scripts.rmse_gate with link 3 at GATE_SPP, its
    record written to a temporary directory: links 1 (against the JAX
    package's CPU render, scratch/rmse_gate/lr_cpu_ref.npz) and 2 must
    pass; link 3 is reported.  Returns the record."""
    from nori_tpu_torch.scripts import rmse_gate

    with tempfile.TemporaryDirectory() as tmp:
        out = rmse_gate.run_gate(spp_full=GATE_SPP, device=dev,
                                 json_out=os.path.join(tmp, "gate.json"))
    for link in ("exact_gate", "mc_scaling"):
        if not out[link]["pass"]:
            raise AssertionError(f"rmse gate: {link} failed: {out[link]}")
    return out


def reference_rows_phase(dev, card: str) -> dict:
    """The rows of scratch/living_room_1024spp_rows.npz (the JAX package's
    CPU render of the ten rows the 1024-spp reference misplaced, one row
    per chunk, tools/reference_rows.py) rendered on the card over the
    same row ranges through the port's checkpoint resume
    (rmse_gate.render_reference_rows): the exact gate of
    rmse_gate.exact_gate (RMSE < 1e-3, < 1% of pixels off by more than
    1e-3) and no pixel off by ROWS_MAX_ABS against the npz, which must be
    there, and ray counts within 0.1% of the JAX render's (as the parity
    render).  Returns the gate's numbers, seconds and rays, and the
    launches."""
    import numpy as np
    from nori_tpu_torch.scripts import rmse_gate

    path = rmse_gate.FULL_REF_ROWS
    if not os.path.exists(path):
        raise AssertionError(f"reference rows: {path} is missing")
    with np.load(path) as d:
        want, rows = d["img"], d["rows"]
        jax_rays = int(d["rays"].sum())
    reset_launches()
    got_rows, img, st = rmse_gate.render_reference_rows(path, device=dev)
    launches = read_launches()
    res = rmse_gate.exact_gate(img, want)
    rel = abs(st["rays"] - jax_rays) / max(jax_rays, 1)
    log(f"reference rows {rows.tolist()}: rmse {res['rmse']:.3e}, pixels "
        f"off {res['pixels_off_gt_1e3']:.4f}, max |diff| "
        f"{res['max_abs_diff']:.3e} (bound {ROWS_MAX_ABS}); rays "
        f"{st['rays']} (card) vs {jax_rays} (JAX on the CPU); "
        f"{st['seconds']:.2f} s on {card}; launches {launches}")
    if got_rows.tolist() != rows.tolist() or not np.isfinite(img).all():
        raise AssertionError("reference rows: rows differ from the npz's "
                             "or are not finite")
    if not (res["pass"] and res["max_abs_diff"] < ROWS_MAX_ABS):
        raise AssertionError(f"reference rows fail the gate: {res}")
    if rel > 1e-3:
        raise AssertionError(f"reference rows: ray counts differ by "
                             f"{rel:.2%}")
    for name in ("entry_min", "resident_sweep", "lane_keys"):
        if launches[name] <= 0:
            raise AssertionError(f"reference rows: {name} never launched")
    return dict(res, seconds=st["seconds"], rays=st["rays"],
                jax_rays=jax_rays, launches=launches)


def pathgraph_eval_phase(dev) -> dict:
    """nori_tpu_torch.scripts.pathgraph_eval with PG_EVAL in a temporary
    directory, then the same command again there: the second call must
    resume every run, the reference and the curve (no kernel launched)
    and give the same JSON.  The first must launch K1 and K2 and give
    finite RMSEs.  Returns its result and launches."""
    import math
    import torch
    from nori_tpu_torch.scripts import pathgraph_eval

    out, launches = [], []
    with tempfile.TemporaryDirectory() as tmp:
        args = PG_EVAL + ["--out", os.path.join(tmp, "eval"),
                          "--device", str(dev)]
        for i in range(2):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            path = os.path.join(tmp, f"result_{i}.json")
            pathgraph_eval.main(args + ["--json-out", path])
            torch.cuda.synchronize()
            launches.append(read_launches())
            with open(path) as f:
                out.append(json.load(f))
            log(f"pathgraph eval call {i + 1}: {time.time() - t0:.1f} s, "
                f"launches {launches[-1]}; {out[-1]}")
    first, again = out
    if again != first:
        raise AssertionError("pathgraph eval: the resumed call's JSON differs")
    if any(launches[1].values()):
        raise AssertionError("pathgraph eval: the second call rendered")
    for name in ("entry_min", "resident_sweep"):
        if launches[0][name] <= 0:
            raise AssertionError(f"pathgraph eval: {name} never launched")
    for key in ("pg_rmse", "pt_same_samples_rmse", "pt_spp_at_parity"):
        if not (math.isfinite(first[key]) and first[key] > 0):
            raise AssertionError(f"pathgraph eval: {key} = {first[key]}")
    return dict(result=first, launches=launches[0])


def _kernel_group(name: str) -> str:
    """Group of a device operation in the whitted batch profile."""
    m = re.search(r"stream_sweep_items<(\w+), (\w+)>", name)
    if m:
        return "K5 stream_sweep, " + (
            "any hit" if m.group(2) == "true" else "closest hit")
    low = name.lower()
    for key, group in (("stream_plan", "K5 stream_sweep, plan"),
                       ("entry_min_kernel", "K1 entry_min"),
                       ("lane_keys_kernel", "K3 lane_keys"),
                       ("resident_sweep_kernel", "K2 resident_sweep"),
                       ("sort", "sorts (entry-key rows, shadow-ray order)"),
                       ("radix", "sorts (entry-key rows, shadow-ray order)"),
                       ("memcpy", "copies"), ("memset", "copies"),
                       ("cat", "copies"), ("copy", "copies"),
                       ("reduce", "reductions"), ("index", "gather / index"),
                       ("gather", "gather / index"),
                       ("scatter", "gather / index"),
                       ("elementwise", "PyTorch elementwise")):
        if key in low:
            return group
    return "other"


def profile_whitted_batch(dev, batch_index: int = 36) -> dict:
    """torch.profiler breakdown of one steady 131,072-sample batch of
    the ajax_rough render on the batch driver's graphed pass (whitted;
    render.make_batch_pass, which replays a batch's stages as CUDA
    graphs on the card), batch `batch_index` of 72 (the middle of the
    image, on the bust).  The batches before it run in order, as a
    render runs them: the first eagerly, the rest replayed; the wall
    time is the median of the five batches before the profiled one,
    each timed to its end on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nori_tpu_torch.render import DEFAULT_BATCH, make_batch_pass

    scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, 16, "whitted")
    sd = scene.compile(dev)
    new_film, pass_fn, _ = make_batch_pass(scene, DEFAULT_BATCH, dev)
    film = new_film()

    def one_batch(b):
        t0 = time.time()
        _, rays = pass_fn(sd, film, SEED, b * DEFAULT_BATCH)
        torch.cuda.synchronize()
        return time.time() - t0, rays

    for b in range(batch_index - 5):
        one_batch(b)
    walls = [one_batch(b)[0] for b in range(batch_index - 5, batch_index)]
    wall_ms = sorted(walls)[2] * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, rays = one_batch(batch_index)
    # the image's last batch releases the pass's graphs
    for b in range(batch_index + 1, -(-AJAX_SIZE * AJAX_SIZE * 16
                                      // DEFAULT_BATCH)):
        one_batch(b)
    groups, top = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(evt, "device_time_total", 0)
              or getattr(evt, "self_device_time_total", 0)) / 1e3
        g = groups.setdefault(_kernel_group(evt.key), [0.0, 0])
        g[0] += ms
        g[1] += evt.count
        top.append((ms, evt.count, evt.key[:90]))
    busy = sum(g[0] for g in groups.values())
    if busy <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    log(f"whitted batch {batch_index}: {DEFAULT_BATCH} samples, "
        f"{int(rays[0])} rays; wall {wall_ms:.3f} ms (median of 5, no "
        f"profiler); device busy {busy:.3f} ms, share "
        f"{busy / wall_ms:.3f}; {sum(g[1] for g in groups.values())} "
        "device operations")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {name:42s} {ms:9.3f} ms  {n:5d} ops  "
            f"{ms / busy:.3f} of busy")
    for ms, n, key in sorted(top, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms {n:5d}x {key}")
    return dict(wall_ms=wall_ms, busy_ms=busy, rays=int(rays[0]),
                groups={k: dict(ms=v[0], ops=v[1]) for k, v in groups.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    with phase("build"):
        build_kernels()
    if "--profile" in sys.argv[1:]:
        with phase("ajax: profile of one whitted batch"):
            print(json.dumps(profile_whitted_batch(dev)))
        print(card)
        return 0

    # the inputs of the two key kernels, shared with scripts/keys_*.py
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from keys_inputs import room_inputs

    with phase("living room: kernel checks"):
        _, sd, k1, k3 = room_inputs(sys.modules[__name__], dev)
        rays, shadow = k1["room check closest"][1], k1["room check shadow"][1]
        records = check_kernels(sd, rays, shadow, k1, k3)
    del k1, k3
    with phase("living room: K4, K2-mxu and K6 checks"):
        records.update(check_merged_mxu_k6(sd, rays, shadow))
    with phase("living room: K6 path"):
        paths = {"k6_path": k6_path(sd, rays, shadow)}
    with phase("living room: parity render"):
        parity_render(dev)
    with phase("living room: full render"):
        img_two, st_two, paths["living_room"] = full_render(
            dev, "full render")
    with phase("living room: merged full render"):
        merged = merged_renders(dev, img_two, st_two)
        paths["living_room_merged"] = merged["launches"]
    with phase("living room: MXU"):
        mxu = mxu_renders(dev, img_two, st_two)
        paths["living_room_mxu"] = mxu["launches"]
    del img_two
    with phase("ajax: kernel checks"):
        ajax = check_ajax_kernels(dev)
    with phase("ajax: parity renders"):
        ajax_parity(dev)
    with phase("ajax: full renders"):
        paths.update(ajax_full_renders(dev))
    with phase("ajax: culled renders"):
        cull = ajax_cull_renders(dev)
        paths["ajax_normals_culled"] = cull["launches"]
    with phase("living room: checkpointed full render"):
        ckpt = checkpointed_renders(dev)
        paths["living_room_checkpointed"] = ckpt.pop("launches")
    with phase("living room: sharded render"):
        sharded = sharded_living_room(dev, ckpt)
        for ranks, res in sharded.items():
            paths[f"living_room_sharded_{ranks}"] = summed(res["launches"])
    with phase("ajax: sharded batch"):
        ajax_sharded = sharded_ajax(dev)
        for ranks in SHARDED_RANKS:
            paths[f"ajax_normals_sharded_{ranks}"] = summed(
                ajax_sharded[ranks]["launches"])
    with phase("multicard: dry run"):
        reset_launches()
        dry = multicard_dry_run(dev)
        # the record keeps each rank's launched kernels only
        paths["multicard_dry_run"] = {
            k: sum(n.get(k, 0) for n in dry["living_room"]["launches"])
            for k in KERNELS}
        paths["multicard_dry_run_reference"] = read_launches()
    with phase("living room: kernel report"):
        report = room_kernel_report(dev)
        paths["kernel_report"] = report.pop("launches")
    with phase("harness: t-tests"):
        ttests = harness_ttests()
        paths["ttest_furnace"] = ttests.pop("launches")
    with phase("harness: chi^2 and warps"):
        chi2_seconds = harness_chi2_warps()
    with phase("harness: ref-gates runner"):
        runner = ref_gates_runner(card)
        paths["ref_gates_runner"] = runner.pop("launches")
    with phase("living room: backends"):
        backends = backend_queries(sd, rays, shadow)
        backends["parity_render"] = bvh_parity_render(dev)
    del rays, shadow, sd
    with phase("path graph: parity"):
        pg_parity = pathgraph_parity(dev)
        paths["pathgraph_parity"] = pg_parity.pop("launches")
    with phase("path graph: protocol run"):
        pg_protocol = pathgraph_protocol(dev)
        paths["pathgraph"] = pg_protocol.pop("launches")
    with phase("bench"):
        bench = bench_phase()
        for name, row in bench["breakdown"].items():
            paths[f"bench_{name}"] = row["launches"]
    with phase("rmse gate (reduced)"):
        gate_record = rmse_gate_phase(dev)
    with phase("living room: reference rows"):
        ref_rows = reference_rows_phase(dev, card)
        paths["living_room_reference_rows"] = ref_rows.pop("launches")
    with phase("path graph: evaluation"):
        pg_eval = pathgraph_eval_phase(dev)
        paths["pathgraph_eval"] = pg_eval.pop("launches")
    log("slice results: " + json.dumps(dict(
        checkpointed=ckpt, ttest_seconds=ttests["seconds"],
        chi2_warp_seconds=chi2_seconds, ref_gates_runner=runner["record"],
        reference_rows=ref_rows, backends=backends,
        pathgraph_parity=pg_parity, pathgraph_protocol=pg_protocol,
        sharded_living_room=sharded, sharded_ajax_normals=ajax_sharded,
        multicard_dry_run=dry,
        kernel_report=report["report"], bench=bench, rmse_gate=gate_record,
        pathgraph_eval=pg_eval["result"])))
    for name in ("stream_sweep", "stream_sweep_culled"):
        records[name] = ajax.pop(name)
    for name, sub in ajax.items():
        records[name]["ajax_slabs"] = sub
    records["resident_sweep_mixed"]["render_seconds"] = merged["seconds"]
    records["resident_sweep_mxu"]["render"] = {
        k: v for k, v in mxu.items() if k != "launches"}
    records["stream_sweep_culled"]["render_seconds"] = {
        "culled": cull["seconds"], "uncut": cull["uncut_seconds"]}
    # each kernel's launches come from the path that runs it
    main_path = {"entry_min": "living_room", "resident_sweep": "living_room",
                 "lane_keys": "living_room",
                 "resident_sweep_mixed": "living_room_merged",
                 "resident_sweep_mxu": "living_room_mxu",
                 "stream_sweep": "ajax_rough",
                 "stream_sweep_culled": "ajax_normals_culled",
                 "mt_sweep": "k6_path"}
    rows = []
    for name in KERNELS:
        r = records[name]
        r["path"] = main_path[name]
        r["launches"] = paths[main_path[name]][name]
        r["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {name} never launched on its path")
        rows.append(r)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
