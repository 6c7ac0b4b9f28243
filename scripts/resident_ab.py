#!/usr/bin/env python3
"""Time the resident sweeps and the living-room render of two checkouts
of the port in turns, on one CUDA card.

    python3 scripts/resident_ab.py ROOT_A ROOT_B

runs one process per turn, in the order A, B, B, A, each importing
nori_tpu_torch and chip_smoke from its root, so each builds and times
its own kernels.  A turn:

* times, at chip_smoke's check shapes (131,072 of the living room's
  wavefront rays and their shadow rays, 404 tiles), K2 BW closest, MT
  closest and BW any-hit, K4 on both sets (262,144 rays) and K2-mxu:
  CUDA events, mean of 10 launches after a warm-up;
* profiles three steady wide wavefront steps (524,288 lanes, after
  three warm-up steps) with torch.profiler: device busy time per step,
  and the resident sweep kernels' share of it, beside the host wall
  time per step (three unprofiled steps, synchronised);
* renders the full living room once through render_to_files (chip_smoke
  FULL: 1280x720, 32 spp, 524,288 lanes).

Each turn prints a line `turn {json}`.  The last lines are the card's
name and power limit and a JSON summary: every turn's numbers per root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

QUERIES = ("bw closest", "mt closest", "bw any-hit", "k4", "mxu")


def profile_steps(cs, scene, sd, dev, n_steps: int = 3) -> dict:
    """Host wall and device time per steady wide wavefront step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nori_tpu_torch.integrators.path import MIS
    from nori_tpu_torch.wavefront import make_wavefront_stepper

    n = cs.FULL["n_lanes"]
    spp = scene.sampler.sample_count
    w, h = scene.camera.output_size
    init, step, _, _ = make_wavefront_stepper(
        scene, MIS, n, 8 * n // spp * spp, device=dev)
    carry = init(cs.SEED, 0, w * h * spp)
    for _ in range(3):
        carry = step(sd, carry, cs.SEED)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n_steps):
        carry = step(sd, carry, cs.SEED)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            carry = step(sd, carry, cs.SEED)
        torch.cuda.synchronize()
    busy = sweep_ms = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(evt, "device_time_total", 0)
              or getattr(evt, "self_device_time_total", 0)) / 1e3
        busy += ms
        if "resident" in evt.key:
            sweep_ms += ms
    if busy <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(step_wall_ms=wall_ms, step_busy_ms=busy / n_steps,
                step_resident_ms=sweep_ms / n_steps)


def turn(root: str) -> dict:
    """One turn on the checkout at `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.scenes_builtin import living_room

    dev = torch.device("cuda:0")
    cs.build_kernels()
    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    rays, shadow = cs.wavefront_rays(scene, sd, dev, cs.CHECK_LANES)
    both = torch.cat([rays, shadow], dim=1).contiguous()
    flags = (torch.arange(both.shape[1] // 256, device=dev)
             >= rays.shape[1] // 256).to(torch.int32)
    kc = sweep.ray_tile_entry_keys(tb, rays)
    ks = sweep.ray_tile_entry_keys(tb, shadow)
    kb = sweep.ray_tile_entry_keys(tb, both)
    calls = {
        "bw closest": lambda: sweep.resident_sweep(sd.tri_bw, *kc, rays),
        "mt closest": lambda: sweep.resident_sweep(sd.tri_packed, *kc, rays),
        "bw any-hit": lambda: sweep.resident_sweep(sd.tri_bw, *ks, shadow,
                                                   True),
        "k4": lambda: sweep.resident_sweep_mixed(sd.tri_bw, *kb, both,
                                                 flags),
        "mxu": lambda: sweep.resident_sweep_mxu(sd.tri_mxu, *kc, rays),
    }
    out = {q: cs.time_ms(calls[q], 10) for q in QUERIES}
    del rays, shadow, both
    out.update(profile_steps(cs, scene, sd, dev))
    img, st, launches = cs.full_render(dev, "full render")
    out.update(render_s=st["seconds"], rays=st["rays"],
               mean=float(img.mean()), steps=st["steps"],
               resident_launches=launches["resident_sweep"])
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
