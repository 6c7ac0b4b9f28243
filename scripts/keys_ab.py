#!/usr/bin/env python3
"""Time the two key kernels (K1 sweep.entry_min, K3 sweep.lane_keys), the
other six kernels, a wavefront step, a whitted batch and two renders of
two checkouts of the port in turns, on one CUDA card.

    python3 scripts/keys_ab.py ROOT_A ROOT_B

runs one process per turn, in the order A, B, B, A, each importing
nori_tpu_torch and chip_smoke from its root, so each builds and times
its own kernels.  A turn:

* times K1 and K3 on every input of scripts/keys_inputs.py (chip_smoke's
  check rays on the living room's 404 tiles and 101 coarsened groups and
  on the ajax stand-in's 1,058 slabs, and what a steady 524,288-lane
  wavefront step and whitted batch 36 hand the two kernels), and, at
  chip_smoke's check shapes, K2 BW closest and any-hit, K4, K2-mxu, K6
  closest, K5 BW closest and any-hit, K5 on batch 36's sorted shadow rays
  and K5-cull MT closest: device time as scripts/keys_visits.py takes it
  (keys_inputs.kernel_ms: CUDA events around 20 launches queued behind a spinning
  kernel);
* profiles three steady wide wavefront steps (524,288 lanes) and one
  whitted batch of ajax_rough (batch 36, 131,072 samples) with
  torch.profiler: device busy time, K1's and K3's part of it and the
  number of device operations, beside the host wall time (synchronised,
  no profiler; the batch's the median of five);
* renders the full living room (chip_smoke FULL) and ajax_rough
  (chip_smoke AJAX_FULL) once each through render_to_files and records
  seconds, rays, mean radiance and a SHA-1 of the image's bytes.

Each turn prints a line `turn {json}`.  The last lines are the card's
name and power limit and a JSON summary: every turn's numbers per root.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time


def profiled(run) -> dict:
    """Device time of one run() under torch.profiler: busy milliseconds,
    K1's and K3's part of them, and the device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = dict(busy_ms=0.0, k1_ms=0.0, k3_ms=0.0, device_ops=0)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(evt, "device_time_total", 0)
              or getattr(evt, "self_device_time_total", 0)) / 1e3
        out["busy_ms"] += ms
        out["device_ops"] += evt.count
        if "entry_min" in evt.key:
            out["k1_ms"] += ms
        if "lane_keys" in evt.key:
            out["k3_ms"] += ms
    if out["busy_ms"] <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return out


def profile_steps(cs, scene, sd, dev, n_steps: int = 3) -> dict:
    """Host wall and device time per steady wide wavefront step."""
    import torch
    from keys_inputs import WARM_STEPS
    from nori_tpu_torch.integrators.path import MIS
    from nori_tpu_torch.wavefront import make_wavefront_stepper

    n = cs.FULL["n_lanes"]
    spp = scene.sampler.sample_count
    w, h = scene.camera.output_size
    init, step, _, _ = make_wavefront_stepper(
        scene, MIS, n, 8 * n // spp * spp, device=dev)
    state = {"carry": init(cs.SEED, 0, w * h * spp)}

    def steps(count):
        for _ in range(count):
            state["carry"] = step(sd, state["carry"], cs.SEED)

    steps(WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.time()
    steps(n_steps)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) / n_steps * 1e3
    prof = profiled(lambda: steps(n_steps))
    return dict(step_wall_ms=wall_ms,
                **{f"step_{k}": v / n_steps for k, v in prof.items()})


def profile_batch(cs, sd, dev) -> dict:
    """Host wall and device time of one steady whitted batch."""
    import torch
    from nori_tpu_torch.render import DEFAULT_BATCH, make_sample_pass_q

    scene = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 16, "whitted")
    pass_fn = make_sample_pass_q(scene, DEFAULT_BATCH, dev)
    q0 = cs.AJAX_SORTED_BATCH * DEFAULT_BATCH
    for _ in range(3):
        pass_fn(sd, cs.SEED, q0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.time()
        pass_fn(sd, cs.SEED, q0)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    prof = profiled(lambda: pass_fn(sd, cs.SEED, q0))
    return dict(batch_wall_ms=sorted(walls)[2] * 1e3,
                **{f"batch_{k}": v for k, v in prof.items()})


def render_row(img, st) -> dict:
    return dict(seconds=st["seconds"], rays=st["rays"],
                mean=float(img.mean()),
                sha1=hashlib.sha1(img.tobytes()).hexdigest())


def turn(root: str) -> dict:
    """One turn on the checkout at `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    from nori_tpu_torch.accel import sweep
    from keys_inputs import ajax_inputs, kernel_ms, room_inputs

    dev = torch.device("cuda:0")
    cs.build_kernels()
    out = {}

    def time_keys(k1, k3):
        for label, (bounds, rays) in k1.items():
            out[f"k1 {label}"] = kernel_ms(
                lambda: sweep.entry_min(bounds, rays))
        for label, (bounds, rays) in k3.items():
            out[f"k3 {label}"] = kernel_ms(
                lambda: sweep.lane_keys(bounds, rays))

    # the living room
    scene, sd, k1, k3 = room_inputs(cs, dev)
    time_keys(k1, k3)
    tb = sd.tri_tile_bounds
    rays, shadow = k1["room check closest"][1], k1["room check shadow"][1]
    both = torch.cat([rays, shadow], dim=1).contiguous()
    flags = (torch.arange(both.shape[1] // 256, device=dev)
             >= rays.shape[1] // 256).to(torch.int32)
    kc = sweep.ray_tile_entry_keys(tb, rays)
    ks = sweep.ray_tile_entry_keys(tb, shadow)
    kb = sweep.ray_tile_entry_keys(tb, both)
    for label, fn in (
            ("k2 bw closest", lambda: sweep.resident_sweep(sd.tri_bw, *kc,
                                                           rays)),
            ("k2 bw any-hit", lambda: sweep.resident_sweep(sd.tri_bw, *ks,
                                                           shadow, True)),
            ("k4", lambda: sweep.resident_sweep_mixed(sd.tri_bw, *kb, both,
                                                      flags)),
            ("k2-mxu", lambda: sweep.resident_sweep_mxu(sd.tri_mxu, *kc,
                                                        rays)),
            ("k6 closest", lambda: sweep.mt_sweep(
                sd.tri_packed, tb, sd.scene_bounds, rays))):
        out[label] = kernel_ms(fn, 10)
    del k1, k3, rays, shadow, both, kc, ks, kb
    out.update(profile_steps(cs, scene, sd, dev))
    img, st, _ = cs.full_render(dev, "full render")
    out["living_room"] = render_row(img, st)
    del scene, sd, tb, img

    # the ajax stand-in
    sd, k1, k3 = ajax_inputs(cs, dev)
    time_keys(k1, k3)
    tb = sd.tri_tile_bounds
    rays, shadow = k1["ajax check closest"][1], k1["ajax check shadow"][1]
    srt = k1["ajax batch shadow sorted"][1]
    kc = sweep.ray_tile_entry_keys(tb, rays)
    ks = sweep.ray_tile_entry_keys(tb, shadow)
    kt = sweep.ray_tile_entry_keys(tb, srt)
    # the gate's boxes, on a checkout whose scene data carries them
    gk = ({"sub_boxes": sd.tri_sub_boxes} if hasattr(sd, "tri_sub_boxes")
          else {})
    for label, fn in (
            ("k5 bw closest", lambda: sweep.stream_sweep(
                sd.tri_bw, *kc, rays, False, True, **gk)),
            ("k5 bw any-hit", lambda: sweep.stream_sweep(
                sd.tri_bw, *ks, shadow, True, True, **gk)),
            ("k5 bw any-hit sorted 131072", lambda: sweep.stream_sweep(
                sd.tri_bw, *kt, srt, True, True, **gk)),
            ("k5-cull mt closest", lambda: sweep.stream_sweep_culled(
                sd.tri_packed, *kc, rays, False, cs.CULL_T))):
        out[label] = kernel_ms(fn, 10)
    del k1, k3, rays, shadow, srt, kc, ks, kt
    out.update(profile_batch(cs, sd, dev))
    del sd, tb
    img, st, _ = cs.ajax_render(dev, "ajax_rough",
                                *cs.AJAX_FULL["ajax_rough"])
    out["ajax_rough"] = render_row(img, st)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        print("turn " + json.dumps(turn(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:3]
    if len(roots) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = {r: [] for r in roots}
    for r in (roots[0], roots[1], roots[1], roots[0]):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", r],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("turn ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"turn on {r} failed ({proc.returncode})")
        res = json.loads(lines[-1][5:])
        runs[r].append(res)
        print(f"{r}: " + json.dumps(res), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
