"""Path-graph evaluation protocol on the living-room workload, on one
CUDA card.  Counterpart of `scripts/pathgraph_eval.py`, with the same
arguments (plus --device), outputs and resume semantics: render a
high-spp path-traced reference (or read one), run N independent
path-graph dumps through the cluster aggregation, merge the per-run
outputs (`hdrmanip --merge`), and report RMSE plus the path-tracing spp
that matches the merged path-graph quality (the fork's per-scene
`refDict` observable, python/utils.py:72-256).

Outputs in --out: reference.exr/.png (when rendered), run_NNN.npz (pg,
pt, width, height, k, iters, seconds) per run, pt_curve.json ({str(spp):
rmse}), pg_k-K_merged.exr/.png and pt_same_samples.exr.  A run whose
checkpoint exists with the same width, height, k and iters is resumed,
as are the reference and the curve points, so an interrupted
protocol-size evaluation continues where it stopped and reports what an
uninterrupted one does: a rendered reference is compared in the
precision reference.exr stores, and a run's recorded seconds are those
of its dump, clusters and aggregation.  The checkpoints are
interchangeable with those of scripts/pathgraph_eval.py.

Usage (from the repository root):
    python -m nori_tpu_torch.scripts.pathgraph_eval [--runs 8] [--k 16]
        [--iters 3] [--res 256] [--ref-spp 256] [--out DIR]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pathgraph_eval")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--ref-exr", default=None,
                    help="reuse an existing reference EXR instead of "
                         "rendering one (the fork stores "
                         "living-room_final.exr the same way)")
    ap.add_argument("--detail", type=int, default=3)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "pg_eval"))
    ap.add_argument("--scene", default="living_room",
                    choices=["living_room", "cornell_box"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; no fallback)")
    args = ap.parse_args(argv)

    import torch

    from nori_tpu_torch import scenes_builtin
    from nori_tpu_torch.bitmap import read_exr, write_exr, write_png
    from nori_tpu_torch.pathgraph import aggregate
    from nori_tpu_torch.pathgraph.bsdfgraph import GraphPoints
    from nori_tpu_torch.pathgraph.cluster import build_clusters, pad_clusters
    from nori_tpu_torch.pathgraph.dump import trace_dump
    from nori_tpu_torch.pathgraph.merge import rmse
    from nori_tpu_torch.pathgraph.pg import _splat_first_hits
    from nori_tpu_torch.device import resolve_device
    from nori_tpu_torch.wavefront import render_wavefront

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    width = args.width or args.res
    height = args.height or args.res

    make = getattr(scenes_builtin, args.scene)
    scene = make(width=width, height=height, spp=1,
                 detail=args.detail) if args.scene == "living_room" \
        else make(width=width, height=height, spp=1)
    n_tris = scene.compile_arrays()["tri_v0"].shape[0]
    print(f"[eval] scene '{args.scene}': {n_tris} tris "
          f"(padded), {width}x{height}")

    # ---- high-spp PT reference -----------------------------------------
    if args.ref_exr:
        ref = read_exr(args.ref_exr)
        if ref.shape[:2] != (height, width):
            raise ValueError(f"reference {ref.shape} != scene "
                             f"{height}x{width}")
        print(f"[eval] reference loaded from {args.ref_exr}")
    elif os.path.exists(os.path.join(args.out, "reference.exr")):
        ref = read_exr(os.path.join(args.out, "reference.exr"))
        if ref.shape[:2] != (height, width):
            raise ValueError(f"stale reference {ref.shape} != scene "
                             f"{height}x{width}")
        print("[eval] reference resumed from earlier run")
    else:
        ref, st = render_wavefront(scene, spp=args.ref_spp, seed=999,
                                   device=dev)
        print(f"[eval] reference {args.ref_spp} spp in "
              f"{st['seconds']:.1f}s ({st['mrays_per_sec']:.2f} Mrays/s)")
        write_exr(os.path.join(args.out, "reference.exr"), ref)
        write_png(os.path.join(args.out, "reference.png"), ref)
        # compare against what a resumed call reads: the EXR's precision
        ref = read_exr(os.path.join(args.out, "reference.exr"))

    # ---- path-graph runs ------------------------------------------------
    # each run's splatted images are checkpointed to <out>/run_NNN.npz,
    # so an interrupted evaluation resumes instead of restarting (the
    # fork's stage-file reuse, src/pathgraph.cpp:8-196)
    pg_fulls, pt_fulls = [], []
    t_pg = 0.0
    for run in range(args.runs):
        ck = os.path.join(args.out, f"run_{run:03d}.npz")
        if os.path.exists(ck):
            d = np.load(ck)
            if (d["width"] == width and d["height"] == height
                    and d["k"] == args.k and d["iters"] == args.iters):
                pg_fulls.append(d["pg"])
                pt_fulls.append(d["pt"])
                t_pg += float(d["seconds"])
                print(f"[eval] run {run + 1}/{args.runs}: resumed "
                      f"from {ck}")
                continue
        t0 = time.time()
        g = trace_dump(scene, max_depth=args.max_depth, seed=run, device=dev)
        gp = GraphPoints(g.sps, dev)
        pos = np.asarray(g.sps["pos"])
        dims = g.grid_dimensions()
        cid, order, offsets = build_clusters(
            pos, dims, g.aabb_min, g.aabb_max, args.k, seed=1994 + run,
            device=dev)
        gp.groupIdx = torch.as_tensor(cid, dtype=torch.int32, device=dev)
        members, sizes = pad_clusters(order, offsets, pad=2 * args.k)
        blur, mc, direct = aggregate.iterate_cluster(
            gp, g.lps, members, sizes, cid, args.iters)
        full = (direct + mc[-1]).cpu().numpy()
        # the seconds a resumed call adds up are these
        seconds = time.time() - t0
        t_pg += seconds

        eLi = np.asarray(g.sps["eLi"])
        lem = np.asarray(g.lps["L_em"])
        # full = re-aggregated direct (incl. vertex emission) + final MC
        full_img, _ = _splat_first_hits(g, full)
        pt_img, _ = _splat_first_hits(g, eLi + lem)
        pg_fulls.append(full_img)
        pt_fulls.append(pt_img)
        tmp = ck + ".tmp.npz"
        np.savez(tmp, pg=full_img.astype(np.float32),
                 pt=pt_img.astype(np.float32),
                 width=width, height=height, k=args.k,
                 iters=args.iters, seconds=seconds)
        os.replace(tmp, ck)
        print(f"[eval] run {run + 1}/{args.runs}: "
              f"{g.num_points} points, {time.time() - t0:.1f}s")

    pg_merged = np.mean(pg_fulls, axis=0)
    pt_merged = np.mean(pt_fulls, axis=0)
    write_exr(os.path.join(args.out, f"pg_k-{args.k}_merged.exr"), pg_merged)
    write_png(os.path.join(args.out, f"pg_k-{args.k}_merged.png"), pg_merged)
    write_exr(os.path.join(args.out, "pt_same_samples.exr"), pt_merged)

    e_pg = rmse(pg_merged, ref, clamp=10.0)
    e_pt = rmse(pt_merged, ref, clamp=10.0)
    print(f"[eval] RMSE vs {args.ref_spp}-spp reference "
          f"({args.runs} merged runs): path-graph {e_pg:.4f}, "
          f"plain PT (same samples) {e_pt:.4f}")

    # ---- equal-RMSE PT spp (refDict observable) -------------------------
    # the PT RMSE-vs-spp curve, and the spp whose RMSE equals the merged
    # path-graph RMSE on the Monte-Carlo model log(e) = a - 0.5 log(spp)
    # fit to the measurements (python/utils.py:168-181)
    pt_curve = []
    curve_ck = os.path.join(args.out, "pt_curve.json")
    done_spp = {}
    if os.path.exists(curve_ck):
        with open(curve_ck) as f:
            done_spp = {int(s): float(e) for s, e in json.load(f).items()}
    match_spp, match_err = None, None
    for spp in (1, 2, 4, 8, 16, 32, 64, 128):
        if spp in done_spp:
            e = done_spp[spp]
        else:
            img, _ = render_wavefront(scene, spp=spp, seed=7, device=dev)
            e = rmse(img, ref, clamp=10.0)
            done_spp[spp] = e
            with open(curve_ck, "w") as f:
                json.dump({str(s): v for s, v in done_spp.items()}, f)
        pt_curve.append((spp, e))
        print(f"[eval] PT {spp} spp -> RMSE {e:.4f}")
        if match_spp is None and e <= e_pg:
            match_spp, match_err = spp, e
        # at least 3 curve points so the power-law fit is determined
        if match_spp is not None and len(pt_curve) >= 3:
            break
    ss = np.array([s for s, _ in pt_curve], np.float64)
    ee = np.array([e for _, e in pt_curve], np.float64)
    fin = np.isfinite(np.log(ee))
    if fin.sum() >= 2:
        slope, icept = np.polyfit(np.log(ss[fin]), np.log(ee[fin]), 1)
    else:
        # degenerate curve: assume the ideal MC slope -1/2
        slope = -0.5
        icept = float(np.log(ee[fin][0]) + 0.5 * np.log(ss[fin][0])) \
            if fin.any() else 0.0
    spp_parity = float(np.exp((np.log(e_pg) - icept) / slope))
    print("[eval] ----------------------------------------")
    print(f"[eval] path-graph ({args.runs} x 1 spp, k={args.k}, "
          f"i={args.iters}) RMSE {e_pg:.4f} in {t_pg:.1f}s")
    print(f"[eval] PT RMSE fit: log e = {icept:.3f} "
          f"{slope:+.3f} log spp  ->  equal-RMSE PT spp ~= "
          f"{spp_parity:.1f} ({spp_parity / args.runs:.1f}x the "
          f"{args.runs} pg samples)")
    if match_spp:
        print(f"[eval] (measured: PT {match_spp} spp reaches RMSE "
              f"{match_err:.4f} <= path-graph)")
    result = {
        "scene": args.scene, "width": width, "height": height,
        "runs": args.runs, "k": args.k, "iters": args.iters,
        "pg_rmse": round(e_pg, 5),
        "pt_same_samples_rmse": round(e_pt, 5),
        "pt_curve": [[int(s), round(e, 5)] for s, e in pt_curve],
        "pt_spp_at_parity": round(spp_parity, 1),
        "speedup_vs_pt": round(spp_parity / args.runs, 2),
        "pg_seconds": round(t_pg, 1),
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[eval] json -> {args.json_out}")
    print(f"[eval] outputs in {args.out}")
    return result


if __name__ == "__main__":
    main()
