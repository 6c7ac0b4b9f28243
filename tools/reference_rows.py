#!/usr/bin/env python3
"""Render rows of the living room's 1024-spp reference image with the
JAX package on the CPU, one image row per chunk.

    JAX_PLATFORMS=cpu python tools/reference_rows.py
        [--out scratch/living_room_1024spp_rows.npz] [--accel bvh|scan]
        [--time-one-row [SPP]]

scratch/living_room_1024spp.exr (1280x720, detail 5, seed 11, 1024 spp)
was rendered in chunks of 2^25 work items; its last chunk is ragged and
the JAX package's dense splat clamps the start of a filter tap's slice
that runs past the film, so that chunk's samples land in the wrong rows
(nori_tpu_torch/scripts/rmse_gate.py, reference_ragged_rows).  This tool
renders those rows again, each row one chunk (W x spp work items),
so no chunk is ragged.  Work items are pixel-major (q = pixel * spp +
sample) and the counter-based RNG keys on q, so a render resumed from a
checkpoint at a row boundary draws the same samples as the uncut render:
the tool writes such a checkpoint (a zero film, next_q0 at the first row
the targets' filter taps reach, 0 rays, the package's own key) and lets
`nori_tpu.wavefront.render_wavefront` resume it for as many chunks as
the rows need.  The image rows it returns equal the uncut render's up to
the order of the film's sums.

Sample values do not depend on the lane count (N_LANES); the merged step
is pinned off (config.MERGED_SWEEP = False), as for every CPU reference
image.  The intersection backend is the JAX package's BVH walk (--accel
bvh, the default): on the CPU the package's own choice for a
51,652-triangle scene is the scan of every triangle (--accel scan),
which tests each ray against all of them.  The two give the same hits
but at ties and in the last bits of a few, which re-seed a path here and
there.

--time-one-row [SPP] renders the first row of the first range alone at
SPP samples per pixel (default 1024) and prints its seconds; nothing is
written.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "scratch", "living_room_1024spp_rows.npz")
#: the reference image's configuration (scratch/README.md)
WIDTH, HEIGHT, SPP, SEED, DETAIL = 1280, 720, 1024, 11, 5
#: the rows its ragged last chunk misplaced
#: (nori_tpu_torch/scripts/rmse_gate.py, RMSE_GATE_torch.json)
TARGET_ROWS = ((697, 700), (714, 719))
#: the lane count of the render
N_LANES = 131072


def living_room(width=WIDTH, height=HEIGHT, spp=SPP, detail=DETAIL):
    from nori_tpu import scenes_builtin as sb

    return sb.living_room(width=width, height=height, spp=spp, detail=detail)


def tap_reach(scene) -> int:
    """Rows a sample's filter taps reach each way (make_dense_splat's
    delta range)."""
    r = float(scene.camera.rfilter.radius)
    return max(-math.ceil(-0.5 - r), math.floor(0.5 + r))


def render_range(scene, spp, seed, first, last, n_lanes, ckpt_path):
    """Render image rows first..last (inclusive) of `scene`, one row per
    chunk, by resuming the JAX package's render_wavefront from a
    checkpoint at row `first`.  Returns ((H, W, 3) image, whose rows with
    every filter tap's source rendered are complete, stats)."""
    from nori_tpu import wavefront as wf

    w, _ = scene.camera.output_size
    scene.sampler.sample_count = spp
    chunk = w * spp
    new_film, _, _ = wf.make_dense_splat(scene, chunk)
    np.savez(ckpt_path, key=wf._checkpoint_key(scene, spp, seed, chunk),
             film=np.asarray(new_film()), next_q0=first * chunk, rays=0)
    return wf.render_wavefront(scene, spp=spp, seed=seed, n_lanes=n_lanes,
                               chunk=chunk, checkpoint_path=ckpt_path,
                               max_chunks=last - first + 1)


def reference_rows(scene, spp, seed, targets, n_lanes, workdir,
                   log=print):
    """(rows, float32 (len(rows), W, 3), per-range records): each target
    range (a, b) is rendered over rows a - reach .. b + reach, clipped to
    the image."""
    from nori_tpu import config

    config.MERGED_SWEEP = False
    w, h = scene.camera.output_size
    reach = tap_reach(scene)
    rows, imgs, ranges = [], [], []
    for a, b in targets:
        first, last = max(0, a - reach), min(h - 1, b + reach)
        t0 = time.time()
        img, st = render_range(scene, spp, seed, first, last, n_lanes,
                               os.path.join(workdir, f"rows_{first}.npz"))
        sec = time.time() - t0
        rows += list(range(a, b + 1))
        imgs.append(np.asarray(img[a:b + 1], np.float32))
        ranges.append({"rendered_rows": [first, last], "rows": [a, b],
                       "q": [first * w * spp, (last + 1) * w * spp],
                       "seconds": sec, "rays": int(st["rays"])})
        log(f"rows {first}-{last} (keeps {a}-{b}): {sec:.1f} s, "
            f"{st['rays']} rays", flush=True)
    return np.asarray(rows), np.concatenate(imgs), ranges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reference_rows")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--accel", default="bvh", choices=("bvh", "scan"),
                    help="the JAX package's config.accel_mode")
    ap.add_argument("--time-one-row", type=int, nargs="?", const=SPP,
                    metavar="SPP")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from nori_tpu import config

    config.MERGED_SWEEP = False
    config.accel_mode = args.accel
    with tempfile.TemporaryDirectory() as tmp:
        if args.time_one_row:
            spp = args.time_one_row
            sc = living_room(spp=spp)
            row = max(0, TARGET_ROWS[0][0] - tap_reach(sc))
            lanes = min(N_LANES, WIDTH * spp)  # no lane idles
            t0 = time.time()
            _, st = render_range(sc, spp, SEED, row, row, lanes,
                                 os.path.join(tmp, "one.npz"))
            print(json.dumps({"row": row, "spp": spp,
                              "seconds": time.time() - t0,
                              "rays": int(st["rays"]),
                              "render_seconds": st["seconds"],
                              "n_lanes": lanes, "accel": args.accel}))
            return 0
        sc = living_room()
        t0 = time.time()
        rows, img, ranges = reference_rows(sc, SPP, SEED, TARGET_ROWS,
                                           N_LANES, tmp)
        seconds = time.time() - t0
    w = sc.camera.output_size[0]
    np.savez(args.out, img=img, rows=rows, seed=SEED, spp=SPP,
             chunk=w * SPP, n_lanes=N_LANES, detail=DETAIL,
             resolution=np.asarray([WIDTH, HEIGHT]),
             rendered_rows=np.asarray([r["rendered_rows"] for r in ranges]),
             q_ranges=np.asarray([r["q"] for r in ranges], np.int64),
             range_seconds=np.asarray([r["seconds"] for r in ranges]),
             rays=np.asarray([r["rays"] for r in ranges], np.int64),
             seconds=seconds, backend=jax.default_backend(),
             accel_mode=args.accel, merged_sweep=False)
    print(f"wrote {args.out}: rows {rows.tolist()} in {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
