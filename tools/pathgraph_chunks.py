#!/usr/bin/env python3
"""Time the path-graph aggregation passes of nori_tpu_torch at several
chunk sizes on one CUDA card.

    python3 tools/pathgraph_chunks.py [--width 1280 --height 720]

Traces one living-room dump (detail 3, depth 8, seed 0: the protocol
run of chip_smoke.py's PG_PROTOCOL by default), builds its k = 16 k-NN
lists and clusters once, printing the seconds of the device and host
parts of each of those stages, then runs each chunked pass at each
chunk size
in turn: the cluster passes (direct_cluster, marginal_cluster, one
re-evaluating iteration of mode opt/t, `_mx_block` over every cluster),
the KNN passes (pdf_sums_knn, one `_mis_block` pass) and last_run.  For
each it prints device seconds (host clock around work that ends in a
synchronise), the peak device memory and the largest difference to the
first chunk size's result (no per-point sum crosses a chunk).  Prints
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLUSTER_CHUNKS = (2048, 4096, 8192, 16384, 32768)
KNN_PAIR_CHUNKS = (8192, 16384, 32768, 65536, 131072)
KNN_CHUNKS = (65536, 131072, 262144, 524288)
LAST_RUN_CHUNKS = (262144, 1 << 20, 1 << 22)


def timed(fn):
    """(result, seconds, peak bytes) of fn() on the card."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated()


def sweep(label, chunks, fn, rows):
    """Run fn(chunk) once untimed at the first chunk, then timed at
    every chunk."""
    ref = fn(chunks[0])
    for chunk in chunks:
        out, sec, peak = timed(lambda: fn(chunk))
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        diff = max(float((a - b).abs().max()) for a, b in zip(outs, refs))
        rows.append(dict(pass_=label, chunk=chunk, seconds=sec,
                         peak_gib=peak / 2 ** 30, max_abs_diff=diff))
        print(f"{label:>18} chunk {chunk:>8}: {sec:8.3f} s, peak "
              f"{peak / 2 ** 30:6.2f} GiB, max |diff| to chunk "
              f"{chunks[0]}: {diff:.3e}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pathgraph_chunks: no CUDA device", file=sys.stderr)
        return 1
    from nori_tpu_torch.pathgraph import aggregate as agg
    from nori_tpu_torch.pathgraph import cluster, dump
    from nori_tpu_torch.pathgraph.bsdfgraph import GraphPoints
    from nori_tpu_torch.pathgraph.grid import UniformGrid, knn
    from nori_tpu_torch.scenes_builtin import living_room

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    k = 16
    stages = {}
    scene = living_room(args.width, args.height, spp=1, detail=3)
    sd = scene.compile(dev)
    cam = scene.camera
    w, h = cam.output_size
    recs, stages["dump: trace (device loop, records to host)"], _ = timed(
        lambda: [{n: v.cpu().numpy() for n, v in dump._trace_batch(
            sd, cam, cam.ray_params(dev), p0, 0, 65536, w * h, w, 8,
            dev).items()} for p0 in range(0, w * h, 65536)])
    g, stages["dump: _assemble (host)"], _ = timed(
        lambda: dump._assemble(scene, recs, w, h, 8, 65536, dev))
    del recs
    gp = GraphPoints(g.sps, dev)
    pos = np.asarray(g.sps["pos"])
    dims = g.grid_dimensions()
    orig_nearest = cluster._nearest_seed

    def nearest(*a, **kw):
        out, stages["clusters: _nearest_seed (device)"], _ = timed(
            lambda: orig_nearest(*a, **kw))
        return out

    cluster._nearest_seed = nearest
    (cid, order, offsets), sec, _ = timed(lambda: cluster.build_clusters(
        pos, dims, g.aabb_min, g.aabb_max, k, device=dev))
    cluster._nearest_seed = orig_nearest
    stages["clusters: the rest (host: seeds, splits, offsets)"] = (
        sec - stages["clusters: _nearest_seed (device)"])
    members, sizes = cluster.pad_clusters(order, offsets, pad=2 * k)
    grid, stages["knn: UniformGrid (host)"], _ = timed(
        lambda: UniformGrid(pos, dims, g.aabb_min, g.aabb_max))
    (nbr, _), stages["knn: knn (device)"], _ = timed(
        lambda: knn(pos, grid, k, device=dev))
    nbr = nbr.long()
    for name, sec in stages.items():
        print(f"{name}: {sec:.3f} s", flush=True)
    print(f"{g.num_points} points, {len(offsets) - 1} clusters",
          flush=True)

    rows = []
    mem, siz, tgt = agg._cluster_tables(gp, members, sizes)
    temp = gp.eLi + gp.eLd
    marginal = agg.marginal_cluster(gp, members, sizes, cid)
    sweep("direct_cluster", CLUSTER_CHUNKS, lambda c: agg.direct_cluster(
        gp, g.lps, members, sizes, chunk=c, include_emitter=False), rows)
    sweep("marginal_cluster", CLUSTER_CHUNKS, lambda c: agg.marginal_cluster(
        gp, members, sizes, cid, chunk=c), rows)
    sweep("mx pass", CLUSTER_CHUNKS, lambda c: agg._per_member(
        gp, mem, siz, tgt, c,
        lambda m, s: agg._mx_block(gp, temp, marginal, m, s), width=3), rows)
    sweep("pdf_sums_knn", KNN_PAIR_CHUNKS,
          lambda c: agg.pdf_sums_knn(gp, nbr, chunk=c), rows)
    pdfsum = agg.pdf_sums_knn(gp, nbr)

    def mis_pass(c):
        n = nbr.shape[0]
        out = torch.empty((n, 3), device=dev)
        for c0 in range(0, n, c):
            c1 = min(c0 + c, n)
            out[c0:c1] = agg._mis_block(gp, temp, agg._arange(c0, c1, gp),
                                        nbr[c0:c1], pdfsum[c0:c1])
        return out

    sweep("mis pass", KNN_CHUNKS, mis_pass, rows)
    sweep("last_run", LAST_RUN_CHUNKS,
          lambda c: agg.last_run(gp, temp, chunk=c), rows)
    print(json.dumps(dict(card=card, points=g.num_points,
                          clusters=len(offsets) - 1, stages=stages,
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
