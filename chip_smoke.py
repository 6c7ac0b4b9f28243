#!/usr/bin/env python3
"""Smoke test of nori_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of the persistent wavefront's path from
nori_tpu_torch/csrc/, holds each against its plain PyTorch version on
the card at the main path's shapes, renders a small scene on the card
and on the CPU and compares the images, then renders the full
living-room workload (1280x720, 32 spp, 51,712 triangles, 524,288
lanes) through `render_to_files` and checks that every kernel of the
path ran.  Any failure raises and exits non-zero; without a CUDA
device it exits non-zero before printing any result.

The last three lines of standard output are one JSON object with the
kernels' checks and times, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
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


def check_kernels(scene, sd, dev, n_lanes: int = CHECK_LANES) -> list:
    """Each kernel against its plain version on the same rays; returns
    the kernels' JSON records (launch counts filled in later)."""
    import torch
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.wavefront import _coarsen_bounds, key_coarsen

    rays, shadow = wavefront_rays(scene, sd, dev, n_lanes)
    tb = sd.tri_tile_bounds
    live = int((rays[6] <= rays[7]).sum())
    live_s = int((shadow[6] <= shadow[7]).sum())
    log(f"check rays: {rays.shape[1]} lanes, {live} live camera/bounce, "
        f"{live_s} live shadow; {tb.shape[0]} tiles, "
        f"{sd.tri_bw.shape[1]} triangles")
    records = []

    # K1: bit-exact
    err = 0.0
    for r in (rays, shadow):
        got, ref = sweep.entry_min(tb, r), sweep.entry_min_plain(tb, r)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            fin = torch.isfinite(ref)
            n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            raise AssertionError(
                f"entry_min differs from its plain version in {n_bad} of "
                f"{ref.numel()} entries (max |diff| on finite "
                f"{float((got - ref)[fin].abs().max())})")
        err = max(err, float((got - ref)[torch.isfinite(ref)].abs().max()))
    records.append(dict(
        name="entry_min", route="cuda", source="nori_tpu_torch/csrc/entry_min.cu",
        replaces="nori_tpu/accel/pallas_mt.py:896", max_abs_err=err,
        ms=time_ms(lambda: sweep.entry_min(tb, rays)),
        plain_ms=time_ms(lambda: sweep.entry_min_plain(tb, rays))))
    log(f"K1 entry_min: bit-exact on both ray sets; "
        f"{records[-1]['ms']:.3f} ms vs plain {records[-1]['plain_ms']:.3f} ms")

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
            err = max(err, float(dt.max()) if dt.numel() else 0.0)
        timing[label] = (
            time_ms(lambda: sweep.resident_sweep(op, keys, bits, r, any_hit)),
            time_ms(lambda: sweep.resident_sweep_plain(op, r, any_hit), 1))
        log(f"K2 resident_sweep {label}: {int(hit_k.sum())} hits agree; "
            f"{timing[label][0]:.3f} ms vs plain {timing[label][1]:.3f} ms")
    records.append(dict(
        name="resident_sweep", route="cuda",
        source="nori_tpu_torch/csrc/resident_sweep.cu",
        replaces="nori_tpu/accel/pallas_mt.py:291", max_abs_err=err,
        ms=timing["bw closest"][0], plain_ms=timing["bw closest"][1]))

    # K3: bit-exact, on the coarsened bounds the wavefront sorts by
    kb = _coarsen_bounds(tb, key_coarsen(tb.shape[0]))
    k1, k2 = sweep.lane_keys(kb, rays)
    p1, p2 = sweep.lane_keys_plain(kb, rays)
    torch.cuda.synchronize()
    if not (torch.equal(k1, p1) and torch.equal(k2, p2)):
        raise AssertionError(
            f"lane_keys differs from its plain version on "
            f"{int(((k1 != p1) | (k2 != p2)).sum())} lanes")
    records.append(dict(
        name="lane_keys", route="cuda", source="nori_tpu_torch/csrc/lane_keys.cu",
        replaces="nori_tpu/accel/pallas_mt.py:982", max_abs_err=0.0,
        ms=time_ms(lambda: sweep.lane_keys(kb, rays)),
        plain_ms=time_ms(lambda: sweep.lane_keys_plain(kb, rays))))
    log(f"K3 lane_keys: bit-exact on {kb.shape[0]} coarsened groups; "
        f"{records[-1]['ms']:.3f} ms vs plain {records[-1]['plain_ms']:.3f} ms")
    return records


def parity_render(dev):
    """The port on the card vs the port on the CPU (plain versions):
    ray counts within 0.1% and the exact image gate of
    scripts/rmse_gate.py (RMSE < 1e-3 and < 1% of pixels off by more
    than 1e-3)."""
    import numpy as np
    from nori_tpu_torch.scenes_builtin import living_room
    from nori_tpu_torch.wavefront import render_wavefront

    cfg = PARITY
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
    log(f"parity render {cfg['width']}x{cfg['height']} spp {cfg['spp']}: "
        f"rays {st_c['rays']} (card) vs {st_p['rays']} (cpu), rmse {rmse:.3e}, "
        f"pixels off {off:.4f}, max |diff| {float(diff.max()):.3e}; "
        f"{st_c['seconds']:.2f} s card, {st_p['seconds']:.2f} s cpu")
    if rel > 1e-3:
        raise AssertionError(f"parity render: ray counts differ by {rel:.2%}")
    if not (rmse < 1e-3 and off < 0.01):
        raise AssertionError("parity render: images fail the exact gate")


def full_render(dev):
    import numpy as np
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.render import render_to_files
    from nori_tpu_torch.scenes_builtin import living_room

    cfg = FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    n_tris = scene.compile_arrays()["tri_bw"].shape[1]
    kernels = (sweep.entry_min, sweep.resident_sweep, sweep.lane_keys)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "living_room")
        for k in kernels:
            k.launches = 0
        img, st = render_to_files(scene, base, seed=SEED,
                                  n_lanes=cfg["n_lanes"], device=dev)
        launches = {k.__name__: k.launches for k in kernels}
        for ext in (".exr", ".png"):
            if os.path.getsize(base + ext) == 0:
                raise AssertionError(f"empty {ext} output")
    log(f"full render {cfg['width']}x{cfg['height']} spp {st['spp']}, "
        f"{n_tris} padded triangles, {cfg['n_lanes']} lanes: "
        f"{st['seconds']:.2f} s")
    log(f"  rays {st['rays']}, {st['mrays_per_sec']:.3f} Mrays/s, "
        f"{st['samples_per_sec']:.1f} samples/s, occupancy "
        f"{st['occupancy']:.4f}, steps {st['steps']} "
        f"(wide {st['wide_steps']})")
    log(f"  launches {launches}")
    if img.shape != (cfg["height"], cfg["width"], 3):
        raise AssertionError(f"image shape {img.shape}")
    if not np.isfinite(img).all():
        raise AssertionError("image holds non-finite values")
    mean = float(img.mean())
    log(f"  mean radiance {mean:.4f} (expected {MEAN_RANGE})")
    if not MEAN_RANGE[0] <= mean <= MEAN_RANGE[1]:
        raise AssertionError(f"mean radiance {mean} outside {MEAN_RANGE}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # outside a checkout of the repo this import fails before any output
    import nori_tpu_torch  # noqa: F401

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_kernels()

    from nori_tpu_torch.scenes_builtin import living_room

    cfg = FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    records = check_kernels(scene, scene.compile(dev), dev)
    parity_render(dev)
    launches = full_render(dev)
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
