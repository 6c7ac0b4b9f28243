"""Matched-RMSE gate of nori_tpu_torch: the chain behind the metric
"spp/s at matched RMSE" (BASELINE.md), run on one CUDA card and held
against the JAX package's committed reference images.  Counterpart of
`scripts/rmse_gate.py`; each link checks the next one's premise:

1. exact gate   — the card's render of the small living-room config
                  (SMALL) matches the JAX package's CPU render of the
                  same config, scratch/rmse_gate/lr_cpu_ref.npz (read,
                  never written): RMSE < 1e-3 and fewer than 1% of
                  pixels off by more than 1e-3.  The counter-based RNG
                  keys every sample on its global id, so sample values
                  do not depend on the backend; float rounding differs,
                  and a ULP in a bounce direction re-seeds that one path,
                  so the criterion bounds no single pixel.
2. MC scaling   — seed-pair RMSE at 64 spp over 1024 spp scales as
                  1/sqrt(spp) (ratio 4, pass within 0.8), so pair RMSE
                  is a valid noise meter.
3. matched gate — two independent full-res renders (seeds 11 and 12)
                  agree to pair RMSE ~ sqrt(2) x the single-image noise;
                  the Mrays/s and spp/s measured on them are throughput
                  at matched RMSE.

At --spp 1024 the seed-11 render of link 3 is also held, under link 1's
criterion, against the JAX package's render of the same seed and size,
scratch/living_room_1024spp.exr, in the precision the file stores (the
card's image rounded through float16 when the file is half): link 1 at
full size, with no extra render.  That file's last chunk was ragged, and
the JAX splat misplaced its samples in ten rows (reference_ragged_rows);
where scratch/living_room_1024spp_rows.npz exists (those rows rendered
again by the JAX package on the CPU, one row per chunk, by
tools/reference_rows.py), the full-size link holds the card's image to a
composite: the EXR's other rows and the npz's rows, the latter in
float32 (composite_reference).

Usage (from the repository root, on a CUDA card):
    python -m nori_tpu_torch.scripts.rmse_gate [--spp 1024]
        [--n-lanes 524288] [--json-out RMSE_GATE_torch.json]

RMSE: python/utils.py:153-166's definition (the fork's), the square
root of the mean over pixels and channels of the squared error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_NPZ = os.path.join(ROOT, "scratch", "rmse_gate", "lr_cpu_ref.npz")
FULL_REF_EXR = os.path.join(ROOT, "scratch", "living_room_1024spp.exr")
#: FULL_REF_EXR's misplaced rows rendered again (tools/reference_rows.py)
FULL_REF_ROWS = os.path.join(ROOT, "scratch", "living_room_1024spp_rows.npz")
#: the spp and seed FULL_REF_EXR was rendered at (scratch/README.md)
FULL_REF_SPP, FULL_REF_SEED = 1024, 11
OUT_JSON = os.path.join(ROOT, "RMSE_GATE_torch.json")

SMALL = dict(width=96, height=54, spp=4, seed=77, n_lanes=8192)
FULL_W, FULL_H = 1280, 720
#: link 1's criterion: RMSE below, and the share of pixels whose largest
#: channel difference exceeds OFF_TOL below OFF_FRAC
RMSE_TOL, OFF_TOL, OFF_FRAC = 1e-3, 1e-3, 0.01


def _scene(width, height, spp):
    from nori_tpu_torch import scenes_builtin as sb

    return sb.living_room(width=width, height=height, spp=spp, detail=5)


def _render(width, height, spp, seed, n_lanes, device=None):
    from nori_tpu_torch.wavefront import render_wavefront

    sc = _scene(width, height, spp)
    img, st = render_wavefront(sc, spp=spp, n_lanes=n_lanes, seed=seed,
                               device=device)
    return np.asarray(img, np.float32), st


def rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def exact_gate(img, ref) -> dict:
    """Link 1's verdict on `img` against `ref`, with its numbers."""
    adiff = np.abs(img - ref)
    frac_off = float(np.mean(np.max(adiff, axis=-1) > OFF_TOL))
    err = rmse(img, ref)
    return {
        "max_abs_diff": float(np.max(adiff)),
        "rmse": err,
        "pixels_off_gt_1e3": frac_off,
        "pass": bool(err < RMSE_TOL and frac_off < OFF_FRAC),
    }


def reference_chunk(total_q: int, n_lanes: int, spp: int) -> int:
    """The work items per chunk the JAX package's render_wavefront takes
    by default (nori_tpu/wavefront.py:776-783)."""
    n_lanes = min(n_lanes, max(4096, total_q))
    chunk = min(total_q, max(64 * n_lanes, 1 << 25))
    return max(spp, (chunk // spp) * spp)


def reference_ragged_rows(width: int, height: int, spp: int, chunk: int,
                          radius: float) -> np.ndarray:
    """(height,) bool: the rows of a JAX-package render in `chunk`-item
    chunks that its dense splat misplaces.  When the last chunk is
    ragged, a filter tap's film slice (the chunk's pixel count long) can
    run past the padded film; jax.lax.dynamic_slice then clamps the
    slice's start, so that tap's samples land higher in the film than
    their pixels (nori_tpu/wavefront.py:637-705; ROADMAP's "a ragged
    last chunk in the JAX package").  The rows are those the chunk's own
    taps cover and those its clamped taps land in."""
    d_lo, d_hi = math.ceil(-0.5 - radius), math.floor(0.5 + radius)
    margin = (abs(d_lo) + 1) * width + abs(d_lo) + d_hi + 1
    n_pix, npix = width * height, chunk // spp
    film_len = n_pix + 2 * margin
    p0 = (math.ceil(width * height * spp / chunk) - 1) * npix
    rows = np.zeros(height, bool)

    def mark(lo, hi):
        lo, hi = max(lo, 0), min(hi, n_pix)
        if lo < hi:
            rows[lo // width:(hi - 1) // width + 1] = True

    for dy in range(d_lo, d_hi + 1):
        for dx in range(d_lo, d_hi + 1):
            start = p0 + dy * width + dx + margin
            if start + npix > film_len:
                landed = film_len - npix - margin
                mark(p0 + dy * width + dx, n_pix)
                mark(landed, landed + n_pix - p0)
    return rows


def load_reference_rows(path: str, seed: int, spp: int, width: int,
                        height: int):
    """(row indices, float32 (len(rows), W, 3)) of the npz that
    tools/reference_rows.py writes, or None where there is no such file;
    raises when it was rendered at another seed, spp or size."""
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        got = (int(d["seed"]), int(d["spp"]), *map(int, d["resolution"]))
        if got != (seed, spp, width, height):
            raise ValueError(f"{path}: seed, spp, size {got} are not "
                             f"{(seed, spp, width, height)}")
        return d["rows"].astype(np.int64), d["img"].astype(np.float32)


def composite_reference(ref, rows, row_img):
    """`ref` with its rows `rows` replaced by `row_img`."""
    out = np.array(ref, np.float32)
    out[rows] = row_img
    return out


def render_rows(scene, seed: int, first: int, last: int, n_lanes: int,
                workdir: str, device=None):
    """Rows first..last of `scene`'s image on `device`, one row (W x spp
    work items) per chunk, by resuming render_wavefront from a checkpoint
    at row `first`: a zero film, next_q0 = first x W x spp, 0 rays and
    the render's key.  Work items are pixel-major and the counter-based
    RNG keys on them, so the rows whose filter taps all lie in
    first..last equal those of an uncut render up to the order of the
    film's sums; the JAX package's checkpoints are the same file
    (tools/reference_rows.py).  Returns ((H, W, 3) image, stats)."""
    from nori_tpu_torch import wavefront as wf

    w, _ = scene.camera.output_size
    spp = scene.sampler.sample_count
    chunk = w * spp
    path = os.path.join(workdir, f"rows_{first}.npz")
    new_film, _, _ = wf.make_dense_splat(scene, chunk, "cpu")
    np.savez(path, key=wf._checkpoint_key(scene, spp, seed, chunk),
             film=new_film().numpy(), next_q0=first * chunk, rays=0)
    return wf.render_wavefront(scene, spp=spp, seed=seed, n_lanes=n_lanes,
                               chunk=chunk, checkpoint_path=path,
                               max_chunks=last - first + 1, device=device)


def render_reference_rows(path: str = FULL_REF_ROWS, n_lanes: int = 524288,
                          device=None):
    """The rows of the npz at `path` rendered on `device` over the same
    row ranges (its rendered_rows) as tools/reference_rows.py rendered
    them.  Returns (rows, float32 (len(rows), W, 3), {"seconds", "rays"}:
    summed over the ranges)."""
    import tempfile

    with np.load(path) as d:
        rows, ranges = d["rows"], d["rendered_rows"].tolist()
        (w, h), spp, seed = d["resolution"], int(d["spp"]), int(d["seed"])
    sc = _scene(int(w), int(h), spp)
    img = np.zeros((len(rows), int(w), 3), np.float32)
    stats = {"seconds": 0.0, "rays": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for first, last in ranges:
            full, st = render_rows(sc, seed, first, last, n_lanes, tmp,
                                   device)
            keep = (rows >= first) & (rows <= last)
            img[keep] = full[rows[keep]]
            stats["seconds"] += st["seconds"]
            stats["rays"] += st["rays"]
    return rows, img, stats


def _rel(path: str) -> str:
    return os.path.relpath(path, ROOT)


def run_gate(spp_full: int = 1024, n_lanes: int = 524288, device=None,
             json_out: str | None = OUT_JSON, ref_npz: str = REF_NPZ,
             full_ref: str = FULL_REF_EXR,
             full_rows: str = FULL_REF_ROWS) -> dict:
    """Run the three links on `device` (default: the first CUDA device;
    device.resolve_device) and write the record to `json_out`."""
    from nori_tpu_torch.bench import card
    from nori_tpu_torch.bitmap import exr_pixel_types, read_exr
    from nori_tpu_torch.device import resolve_device

    device = resolve_device(device)
    dev = card(device)
    out = {"device": dev, "date": time.strftime("%Y-%m-%d"),
           "config_small": SMALL,
           "rmse_def": "sqrt(mean((a-b)^2)) over all pixels/channels"}

    # 1) exact gate against the JAX package's CPU render
    ref = np.load(ref_npz)
    if json.loads(str(ref["config"])) != SMALL:
        raise ValueError(f"{ref_npz}: config {ref['config']} is not {SMALL}")
    img, _ = _render(SMALL["width"], SMALL["height"], SMALL["spp"],
                     SMALL["seed"], SMALL["n_lanes"], device)
    exact = exact_gate(img, ref["img"])
    exact.update(reference=_rel(ref_npz), mc_noise_scale_at_4spp="~1e-1")
    out["exact_gate"] = exact
    print(f"1 exact gate vs {_rel(ref_npz)}: max|diff|="
          f"{exact['max_abs_diff']:.2e} rmse={exact['rmse']:.2e} "
          f"off-frac={exact['pixels_off_gt_1e3']:.4f} pass={exact['pass']}",
          flush=True)

    # 2) MC 1/sqrt(spp) scaling at small res (cheap, tight statistics)
    a64, _ = _render(SMALL["width"], SMALL["height"], 64, 21, 65536, device)
    b64, _ = _render(SMALL["width"], SMALL["height"], 64, 22, 65536, device)
    pair64 = rmse(a64, b64)

    # 3) matched gate: two independent full-res renders
    t0 = time.time()
    a, st_a = _render(FULL_W, FULL_H, spp_full, FULL_REF_SEED, n_lanes,
                      device)
    wall_a = time.time() - t0
    b, _ = _render(FULL_W, FULL_H, spp_full, FULL_REF_SEED + 1, n_lanes,
                   device)
    pair_full = rmse(a, b)
    if spp_full == FULL_REF_SPP:
        # link 1 at full size: the JAX package's render of seed 11
        kinds = set(exr_pixel_types(full_ref).values())
        if kinds - {"half", "float"}:
            raise ValueError(f"{full_ref}: pixel types {kinds}")
        mine = a.astype(np.float16).astype(np.float32) \
            if kinds == {"half"} else a
        ref_full = read_exr(full_ref)
        # the rows the reference's own splat misplaced, and the gate on
        # the others
        radius = _scene(FULL_W, FULL_H, spp_full).camera.rfilter.radius
        chunk = reference_chunk(FULL_W * FULL_H * spp_full, n_lanes,
                                spp_full)
        ragged = reference_ragged_rows(FULL_W, FULL_H, spp_full, chunk,
                                       radius)
        rest = exact_gate(mine[~ragged], ref_full[~ragged])
        jax_rows = load_reference_rows(full_rows, FULL_REF_SEED, spp_full,
                                       FULL_W, FULL_H)
        extra = {}
        if jax_rows is not None:
            # those rows from the JAX package's row-chunked render, held
            # in float32
            rows, row_img = jax_rows
            ref_full = composite_reference(ref_full, rows, row_img)
            mine = composite_reference(mine, rows, a[rows])
            extra = dict(reference_rows=_rel(full_rows),
                         jax_rows=rows.tolist(),
                         ragged_rows_against_jax_rows=exact_gate(
                             a[rows], row_img))
        full = exact_gate(mine, ref_full)
        full.update(reference=_rel(full_ref), stored_as=sorted(kinds),
                    resolution=[FULL_W, FULL_H], spp=spp_full,
                    seed=FULL_REF_SEED, n_lanes=n_lanes,
                    reference_chunk=chunk,
                    reference_ragged_rows=np.flatnonzero(ragged).tolist(),
                    outside_ragged_rows=rest, **extra)
        out["exact_gate_full"] = full
        print(f"1 exact gate at full size vs {_rel(full_ref)} "
              f"({'/'.join(sorted(kinds))})"
              + (f" and {_rel(full_rows)}" if extra else "")
              + f": max|diff|={full['max_abs_diff']:.2e} "
              f"rmse={full['rmse']:.2e} "
              f"off-frac={full['pixels_off_gt_1e3']:.4f} "
              f"pass={full['pass']}; outside the {int(ragged.sum())} rows "
              f"the reference's ragged last chunk misplaced: max|diff|="
              f"{rest['max_abs_diff']:.2e} rmse={rest['rmse']:.2e} "
              f"off-frac={rest['pixels_off_gt_1e3']:.4f} "
              f"pass={rest['pass']}", flush=True)
        if extra:
            on = extra["ragged_rows_against_jax_rows"]
            print(f"  those rows vs the JAX rows: max|diff|="
                  f"{on['max_abs_diff']:.2e} rmse={on['rmse']:.2e} "
                  f"off-frac={on['pixels_off_gt_1e3']:.4f} "
                  f"pass={on['pass']}", flush=True)
    a256, _ = _render(SMALL["width"], SMALL["height"], 1024, 31, 65536,
                      device)
    b256, _ = _render(SMALL["width"], SMALL["height"], 1024, 32, 65536,
                      device)
    pair1024_small = rmse(a256, b256)
    scaling = {
        "pair_rmse_64spp_small": pair64,
        "pair_rmse_1024spp_small": pair1024_small,
        "ratio": pair64 / pair1024_small,
        "model_ratio": 4.0,
        "pass": bool(abs(pair64 / pair1024_small - 4.0) < 0.8),
    }
    out["mc_scaling"] = scaling
    print(f"2 MC scaling: 64spp {pair64:.5f} / 1024spp "
          f"{pair1024_small:.5f} = {scaling['ratio']:.2f} "
          f"(model 4.0) pass={scaling['pass']}", flush=True)

    matched = {
        "resolution": [FULL_W, FULL_H], "spp": spp_full,
        "pair_rmse": pair_full,
        "single_image_mc_noise": pair_full / np.sqrt(2.0),
        "mrays_per_sec": st_a["mrays_per_sec"],
        # over the host's wall around the render, the scene's build and
        # upload included, as scripts/rmse_gate.py counts it
        "spp_per_sec": spp_full / wall_a,
        "seconds": wall_a,
        "render_seconds": st_a["seconds"],
        "rays": st_a["rays"],
        "device": dev["name"], "power_limit": dev["power_limit"],
    }
    out["matched_gate"] = matched
    print(f"3 matched gate: pair rmse={pair_full:.5f} -> single-image "
          f"noise {matched['single_image_mc_noise']:.5f}; "
          f"{matched['mrays_per_sec']:.2f} Mrays/s, "
          f"{matched['spp_per_sec']:.2f} spp/s on {dev['name']} "
          f"({dev['power_limit']})", flush=True)

    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {json_out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rmse_gate")
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--n-lanes", type=int, default=524288)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; no fallback)")
    ap.add_argument("--json-out", default=OUT_JSON)
    args = ap.parse_args(argv)
    out = run_gate(args.spp, args.n_lanes, args.device, args.json_out)
    verdicts = [out["exact_gate"]["pass"], out["mc_scaling"]["pass"]]
    if "exact_gate_full" in out:
        verdicts.append(out["exact_gate_full"]["pass"])
    return 0 if all(verdicts) else 1


if __name__ == "__main__":
    raise SystemExit(main())
