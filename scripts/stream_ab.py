#!/usr/bin/env python3
"""Time the streamed sweep (K5, K5-cull), the 2-D sweep (K6) and the
ajax renders of two checkouts of the port in turns, on one CUDA card.

    python3 scripts/stream_ab.py ROOT_A ROOT_B

runs one process per turn, in the order A, B, B, A, each importing
nori_tpu_torch and chip_smoke from its root, so each builds and times
its own kernels.  A turn:

* times, at chip_smoke's check shapes on the ajax stand-in (541,696
  triangles, 1,058 slabs; 32,768 camera rays and their shadow rays), K5
  BW closest, MT closest, BW any-hit and MT any-hit, and K5-cull MT
  closest and any-hit; K5 BW any-hit on the 131,072 shadow rays of
  whitted batch 36, as traverse.occluded sorts them and unsorted, and K5
  BW closest on that batch's camera rays; K6 culled, closest and
  any-hit, on the living room's 131,072 check rays (with its K1 and
  argsort): CUDA events, mean of 10 launches after a warm-up;
* profiles one steady whitted batch of ajax_rough (batch 36, 131,072
  samples, after three warm-up runs) with torch.profiler: device busy
  time and the streamed sweep kernels' share of it, beside the host
  wall time (median of five unprofiled runs, synchronised);
* renders ajax_normals and ajax_rough once each through render_to_files
  (chip_smoke AJAX_FULL: 768x768, 4 and 16 spp) and records seconds,
  rays, mean radiance and a SHA-1 of the image's bytes.

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


def profile_batch(cs, dev, batch_index: int) -> dict:
    """Host wall and device time of one steady whitted batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nori_tpu_torch.render import DEFAULT_BATCH, make_sample_pass_q

    scene = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 16, "whitted")
    sd = scene.compile(dev)
    pass_fn = make_sample_pass_q(scene, DEFAULT_BATCH, dev)
    q0 = batch_index * DEFAULT_BATCH
    for _ in range(3):
        pass_fn(sd, cs.SEED, q0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.time()
        pass_fn(sd, cs.SEED, q0)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pass_fn(sd, cs.SEED, q0)
        torch.cuda.synchronize()
    busy = k5_ms = 0.0
    ops = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(evt, "device_time_total", 0)
              or getattr(evt, "self_device_time_total", 0)) / 1e3
        busy += ms
        ops += evt.count
        if "stream_" in evt.key:
            k5_ms += ms
    if busy <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(batch_wall_ms=sorted(walls)[2] * 1e3, batch_busy_ms=busy,
                batch_k5_ms=k5_ms, batch_device_ops=ops)


def turn(root: str) -> dict:
    """One turn on the checkout at `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    from nori_tpu_torch.accel import sweep
    from stream_inputs import ajax_inputs, gate_kw, room_inputs

    dev = torch.device("cuda:0")
    cs.build_kernels()
    a = ajax_inputs(cs, dev)
    sd, tb, rays, shadow = a.sd, a.sd.tri_tile_bounds, a.rays, a.shadow
    calls = {}
    for label, op, use_bw, r, ah in (
            ("k5 bw closest", sd.tri_bw, True, rays, False),
            ("k5 mt closest", sd.tri_packed, False, rays, False),
            ("k5 bw any-hit", sd.tri_bw, True, shadow, True),
            ("k5 mt any-hit", sd.tri_packed, False, shadow, True),
            ("k5 bw any-hit sorted 131072", sd.tri_bw, True, a.srt, True),
            ("k5 bw any-hit unsorted 131072", sd.tri_bw, True, a.shadow_b,
             True),
            ("k5 bw closest 131072", sd.tri_bw, True, a.rays_b, False)):
        kb = sweep.ray_tile_entry_keys(tb, r)
        calls[label] = (lambda op=op, kb=kb, r=r, ah=ah, use_bw=use_bw:
                        sweep.stream_sweep(op, *kb, r, ah, use_bw,
                                           **gate_kw(sd)))
    for label, r, ah in (("k5-cull mt closest", rays, False),
                         ("k5-cull mt any-hit", shadow, True)):
        kb = sweep.ray_tile_entry_keys(tb, r)
        calls[label] = (lambda kb=kb, r=r, ah=ah: sweep.stream_sweep_culled(
            sd.tri_packed, *kb, r, ah, cs.CULL_T))
    out = {label: cs.time_ms(fn, 10) for label, fn in calls.items()}
    del calls, a, sd, tb, rays, shadow

    room = room_inputs(cs, dev)
    rsd, rays, shadow = room.sd, room.rays, room.shadow
    for label, r, ah in (("k6 closest", rays, False),
                         ("k6 any-hit", shadow, True)):
        out[label] = cs.time_ms(lambda: sweep.mt_sweep(
            rsd.tri_packed, rsd.tri_tile_bounds, rsd.scene_bounds, r,
            any_hit=ah), 10)
    del room, rsd, rays, shadow

    out.update(profile_batch(cs, dev, cs.AJAX_SORTED_BATCH))
    for name, spec in cs.AJAX_FULL.items():
        img, st, launches = cs.ajax_render(dev, name, *spec)
        out[name] = dict(
            seconds=st["seconds"], rays=st["rays"], mean=float(img.mean()),
            sha1=hashlib.sha1(img.tobytes()).hexdigest(),
            k5_launches=launches["stream_sweep"])
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
