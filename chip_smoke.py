#!/usr/bin/env python3
"""Smoke test of nori_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels (K1 entry_min, K2 resident_sweep, K3
lane_keys, K5 stream_sweep) from nori_tpu_torch/csrc/ and drives two
paths of the port, each through its kernels:

* the persistent wavefront on the living room (51,712 triangles, K1,
  K2, K3): each kernel against its plain PyTorch version on the card at
  the path's shapes, a small render on the card against the CPU, and
  the full 1280x720, 32 spp, 524,288-lane render through
  `render_to_files`;
* the batch driver on the ajax composition (the 541,696-triangle
  procedural stand-in for the pa2/pa5 ajax scan, streamed layout, K1,
  K3, K5): the kernels against their plain versions on the slab
  bounds and 32,768 camera and shadow rays, K5 any-hit also on one
  whole 131,072-sample whitted batch's shadow rays in the order
  `traverse.occluded` sorts them, normals/whitted/path_mis
  renders on the card against the CPU, and the full ajax_normals
  (768x768, 4 spp) and ajax_rough (768x768, 16 spp, whitted) renders
  through `render_to_files`, which must launch K5 and never K2.

Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing any result.  Every phase prints its time.

The last three lines of standard output are one JSON object with the
kernels' checks and times, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

builds the kernels and prints only a torch.profiler breakdown of one
131,072-sample whitted batch of the ajax_rough render.
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

#: the ajax composition: camera of scenes/pa2/ajax-normals.xml (fov 30,
#: 768x768), the stand-in bust (microfacet alpha 0.2, kd 0.3) and an
#: emissive quad standing in for scenes/pa5/ajax/light.obj: y 6.3-33.7,
#: 50 degrees around the bust from the camera, facing the bust
AJAX_ORIGIN = [-65.6055, 47.5762, 24.3583]
AJAX_TARGET = [-64.8161, 47.2211, 23.8576]
AJAX_UP = [0.299858, 0.934836, -0.190177]
AJAX_LIGHT = ([-58.437, 6.3, 35.786], [-58.437, 33.7, 35.786],
              [-38.614, 33.7, 38.436], [-38.614, 6.3, 38.436])
AJAX_RADIANCE = [8.0, 8.0, 8.0]
#: full renders: (integrator, spp, mean-radiance band).  The bands come
#: from the port's CPU renders of the same composition at 48x48 with
#: the stand-in at n_lat=128, n_lon=132: normals 0.4920 and 0.4918,
#: whitted 0.0618 and 0.0628 (seeds 1 and 2; 0.4944 and 0.0623/0.0640
#: at 64x66); they allow for resolution, tessellation and noise
AJAX_FULL = {
    "ajax_normals": ("normals", 4, (0.44, 0.54)),
    "ajax_rough": ("whitted", 16, (0.050, 0.076)),
}
AJAX_SIZE = 768
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
    kb = _coarsen_bounds(tb, key_coarsen(sd.tri_packed.shape[0],
                                         tb.shape[0]))
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


# ---------------------------------------------------------------------------
# the streamed path: the ajax composition through the batch driver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    log(f"== {name}")
    yield
    log(f"== {name}: {time.time() - t0:.1f} s")


def ajax_scene(width: int, height: int, spp: int, integrator: str,
               n_lat: int = 512, n_lon: int = 530):
    """The ajax composition (see AJAX_*), with the stand-in bust at
    n_lat x n_lon."""
    from nori_tpu_torch import scenes_builtin as sb
    from nori_tpu_torch.core.transform import Transform
    from nori_tpu_torch.props import PropertyList
    from nori_tpu_torch.registry import create_instance
    from nori_tpu_torch.scene import Scene

    md = sb.ajax_standin_meshdata(n_lat=n_lat, n_lon=n_lon)
    scene = Scene(PropertyList())
    scene.add_child(sb._mesh_obj(
        md.positions, md.faces,
        sb._bsdf("microfacet", alpha=0.2, kd=[0.3, 0.3, 0.3]), name="ajax"))
    v, f = sb._quad(*AJAX_LIGHT)
    scene.add_child(sb._mesh_obj(
        v, f, sb._bsdf("diffuse", albedo=[0.0, 0.0, 0.0]),
        emitter=sb._area_light(AJAX_RADIANCE), name="light"))
    cam_pl = PropertyList()
    cam_pl.set_integer("width", width)
    cam_pl.set_integer("height", height)
    cam_pl.set_float("fov", 30.0)
    cam_pl.set_transform("toWorld", Transform.lookat(AJAX_ORIGIN,
                                                     AJAX_TARGET, AJAX_UP))
    cam = create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)
    samp_pl = PropertyList()
    samp_pl.set_integer("sampleCount", spp)
    scene.add_child(create_instance("independent", samp_pl))
    scene.add_child(create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


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


def compare_sweep(label: str, got, ref, any_hit: bool) -> float:
    """Equal hit masks, and for closest hits t within rtol 1e-6 and
    equal triangles (the kernels round as their plain versions and
    break ties alike); returns max |dt|."""
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
    return float(dt.max()) if dt.numel() else 0.0


def check_ajax_kernels(dev) -> dict:
    """K1 and K3 on the 1,058 slab bounds and K5 (BW closest, MT
    closest, BW any-hit) against their plain versions; returns
    {kernel name: record}."""
    import torch
    from nori_tpu_torch.accel import sweep

    scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, 4, "whitted")
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    if sd.tri_bw.shape != (16, AJAX_TRIS) or tb.shape[0] != AJAX_SLABS:
        raise AssertionError(f"ajax layout {tuple(sd.tri_bw.shape)}, "
                             f"{tb.shape[0]} slabs")
    # AJAX_CHECK_LANES work items spread evenly over the image
    n = AJAX_CHECK_LANES
    w, h = scene.camera.output_size
    q = torch.arange(n, dtype=torch.int64, device=dev) * (
        w * h * scene.sampler.sample_count // n)
    rays, shadow = ajax_rays(scene, sd, dev, q)
    live = int((rays[6] <= rays[7]).sum())
    live_s = int((shadow[6] <= shadow[7]).sum())
    log(f"ajax check rays: {rays.shape[1]} camera ({live} live), "
        f"{live_s} live shadow; {tb.shape[0]} slabs of 512")
    out = {}

    for r in (rays, shadow):
        got, ref = sweep.entry_min(tb, r), sweep.entry_min_plain(tb, r)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError("entry_min differs from its plain version "
                                 "on the slab bounds")
    out["entry_min"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: sweep.entry_min(tb, rays)),
        plain_ms=time_ms(lambda: sweep.entry_min_plain(tb, rays)))
    log(f"K1 entry_min (slabs): bit-exact; {out['entry_min']['ms']:.3f} ms "
        f"vs plain {out['entry_min']['plain_ms']:.3f} ms")

    for r in (rays, shadow):
        k1, k2 = sweep.lane_keys(tb, r)
        p1, p2 = sweep.lane_keys_plain(tb, r)
        torch.cuda.synchronize()
        if not (torch.equal(k1, p1) and torch.equal(k2, p2)):
            raise AssertionError(
                f"lane_keys differs from its plain version on the slab "
                f"bounds on {int(((k1 != p1) | (k2 != p2)).sum())} lanes")
    out["lane_keys"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: sweep.lane_keys(tb, shadow)),
        plain_ms=time_ms(lambda: sweep.lane_keys_plain(tb, shadow)))
    log(f"K3 lane_keys ({tb.shape[0]} slabs): bit-exact; "
        f"{out['lane_keys']['ms']:.3f} ms vs plain "
        f"{out['lane_keys']['plain_ms']:.3f} ms")

    err, timing = 0.0, {}
    for label, use_bw, r, any_hit in (
            ("bw closest", True, rays, False),
            ("mt closest", False, rays, False),
            ("bw any-hit", True, shadow, True)):
        op = sd.tri_bw if use_bw else sd.tri_packed
        keys, bits = sweep.ray_tile_entry_keys(tb, r)

        def kern():
            return sweep.stream_sweep(op, keys, bits, r, any_hit, use_bw)

        def plain():
            return sweep.stream_sweep_plain(op, r, any_hit, use_bw)

        got = kern()
        err = max(err, compare_sweep(f"stream_sweep {label}", got, plain(),
                                     any_hit))
        timing[label] = (time_ms(kern), time_ms(plain, 1))
        log(f"K5 stream_sweep {label}: {int((got[1] >= 0).sum())} hits "
            f"agree; {timing[label][0]:.3f} ms vs plain "
            f"{timing[label][1]:.3f} ms")
    timing.update(check_sorted_any_hit(sd, dev))
    out["stream_sweep"] = dict(
        name="stream_sweep", route="cuda",
        source="nori_tpu_torch/csrc/stream_sweep.cu",
        replaces="nori_tpu/accel/pallas_mt.py:526", max_abs_err=err,
        ms=timing["bw closest"][0], plain_ms=timing["bw closest"][1],
        by_query={k: dict(ms=v[0], plain_ms=v[1]) for k, v in timing.items()})
    return out


def check_sorted_any_hit(sd, dev):
    """K5 any-hit on the shadow rays of one whole 131,072-sample batch
    of ajax_rough, swept in the order traverse.occluded sorts them (K3
    keys on the 1,058 slab bounds), against the plain sweep of the same
    rays unsorted; then the kernel on the unsorted rays and
    traverse.occluded itself against it.  Returns {label: (kernel ms,
    plain ms)} for the sorted and the unsorted order."""
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

    def kern():
        return sweep.stream_sweep(sd.tri_bw, keys, bits, srt, True, True)

    def kern_unsorted():
        return sweep.stream_sweep(sd.tri_bw, keys_u, bits_u, shadow, True,
                                  True)

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
    log(f"K5 stream_sweep bw any-hit sorted (batch {AJAX_SORTED_BATCH}, "
        f"{DEFAULT_BATCH} rays, {int((shadow[6] <= shadow[7]).sum())} live): "
        f"{int(hit_p.sum())} hits agree, traverse.occluded agrees; "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms; the same rays unsorted "
        f"agree too, {ms_u:.3f} ms; the sort (K3, argsort, gather) "
        f"{sort_ms:.3f} ms")
    return {"bw any-hit sorted": (ms, plain_ms),
            "bw any-hit unsorted": (ms_u, plain_ms)}


def gate(label: str, a, st_a, b, st_b):
    """Equal ray counts and the exact image gate of scripts/rmse_gate.py
    (RMSE < 1e-3 and < 1% of pixels off by more than 1e-3)."""
    import numpy as np

    diff = np.abs(a - b)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    off = float(np.mean(diff.max(axis=-1) > 1e-3))
    log(f"{label}: rays {st_a['rays']} (card) vs {st_b['rays']} (cpu), "
        f"rmse {rmse:.3e}, pixels off {off:.4f}, max |diff| "
        f"{float(diff.max()):.3e}, mean {float(a.mean()):.4f}; "
        f"{st_a['seconds']:.2f} s card, {st_b['seconds']:.2f} s cpu")
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


def ajax_full_renders(dev) -> dict:
    """ajax_normals and ajax_rough at full size through render_to_files;
    returns {render name: {kernel name: launches}}."""
    import numpy as np
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.render import render_to_files

    kernels = (sweep.entry_min, sweep.resident_sweep, sweep.lane_keys,
               sweep.stream_sweep)
    launches = {}
    for name, (integrator, spp, band) in AJAX_FULL.items():
        scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, spp, integrator)
        with tempfile.TemporaryDirectory() as tmp:
            base = os.path.join(tmp, name)
            for k in kernels:
                k.launches = 0
            img, st = render_to_files(scene, base, seed=SEED, device=dev)
            n = {k.__name__: k.launches for k in kernels}
            for ext in (".exr", ".png"):
                if os.path.getsize(base + ext) == 0:
                    raise AssertionError(f"{name}: empty {ext} output")
        launches[name] = n
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
            raise AssertionError(f"{name}: mean radiance {mean} outside "
                                 f"{band}")
        if integrator == "normals" and st["rays"] != AJAX_SIZE ** 2 * spp:
            raise AssertionError(f"{name}: {st['rays']} rays, expected "
                                 f"{AJAX_SIZE ** 2 * spp}")
        need = ["entry_min", "stream_sweep"] + (
            ["lane_keys"] if integrator == "whitted" else [])
        for k in need:
            if n[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        if n["resident_sweep"] != 0:
            raise AssertionError(f"{name}: the resident sweep ran on a "
                                 "streamed scene")
    return launches


def _kernel_group(name: str) -> str:
    """Group of a device operation in the whitted batch profile."""
    m = re.search(r"stream_sweep_kernel<(\w+), (\w+)>", name)
    if m:
        return "K5 stream_sweep, " + (
            "any hit" if m.group(2) == "true" else "closest hit")
    low = name.lower()
    for key, group in (("entry_min_kernel", "K1 entry_min"),
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
    the ajax_rough render (the batch driver with whitted), batch
    `batch_index` of 72 (the middle of the image, on the bust); the
    wall time is the median of five unprofiled runs of the same batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nori_tpu_torch.render import DEFAULT_BATCH, make_sample_pass_q

    scene = ajax_scene(AJAX_SIZE, AJAX_SIZE, 16, "whitted")
    sd = scene.compile(dev)
    pass_fn = make_sample_pass_q(scene, DEFAULT_BATCH, dev)
    q0 = batch_index * DEFAULT_BATCH
    for _ in range(3):
        pass_fn(sd, SEED, q0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.time()
        _, rays = pass_fn(sd, SEED, q0)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall_ms = sorted(walls)[2] * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pass_fn(sd, SEED, q0)
        torch.cuda.synchronize()
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
        f"{int(rays)} rays; wall {wall_ms:.3f} ms (median of 5, no "
        f"profiler); device busy {busy:.3f} ms, share "
        f"{busy / wall_ms:.3f}; {sum(g[1] for g in groups.values())} "
        "device operations")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {name:42s} {ms:9.3f} ms  {n:5d} ops  "
            f"{ms / busy:.3f} of busy")
    for ms, n, key in sorted(top, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms {n:5d}x {key}")
    return dict(wall_ms=wall_ms, busy_ms=busy, rays=int(rays),
                groups={k: dict(ms=v[0], ops=v[1]) for k, v in groups.items()})


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
    with phase("build"):
        build_kernels()
    if "--profile" in sys.argv[1:]:
        with phase("ajax: profile of one whitted batch"):
            print(json.dumps(profile_whitted_batch(dev)))
        print(card)
        return 0

    from nori_tpu_torch.scenes_builtin import living_room

    cfg = FULL
    with phase("living room: kernel checks"):
        scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                            detail=cfg["detail"])
        records = check_kernels(scene, scene.compile(dev), dev)
    with phase("living room: parity render"):
        parity_render(dev)
    with phase("living room: full render"):
        launches = full_render(dev)
    with phase("ajax: kernel checks"):
        ajax = check_ajax_kernels(dev)
    with phase("ajax: parity renders"):
        ajax_parity(dev)
    with phase("ajax: full renders"):
        ajax_launches = ajax_full_renders(dev)
    records.append(ajax.pop("stream_sweep"))
    for r in records:
        if r["name"] in ajax:
            r["ajax_slabs"] = ajax[r["name"]]
        r["launches_by_path"] = {"living_room": launches.get(r["name"], 0)}
        r["launches_by_path"].update(
            {k: v[r["name"]] for k, v in ajax_launches.items()})
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
