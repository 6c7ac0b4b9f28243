"""`pg` driver: load/build/iterate/write (src/cluster.cpp:156-254).

Port of `nori_tpu/pathgraph/pg.py`.

CLI:  python -m nori_tpu_torch.pathgraph.pg <base> -k K -i ITERS -m MODE
          [--save-dump] [--device D]
  MODE (src/cluster.cpp:201-226):
        opt  — clusters + direct-light re-aggregation + matrix
               iterations, final-only recording
               (ClusterScatterWithDirectOptNR / ClusterIterations3)
        n    — clusters + PRECOMPUTED matrix elements, stored per-point
               direct in the update, per-iteration recording
               (ClusterScatter2 / ClusterIterations)
        t    — clusters + per-iteration BSDF re-evaluation, stored
               per-point direct, per-iteration recording
               (ClusterScatter / computeClusterScatterAllOnGPURecord)
        l    — load neighbors/clusters from <base>neighbors.bin, then
               the "t" iteration (loadClusterScatter)
        knn  — k-NN MIS aggregation with per-iteration recording
              (computeMISRadianceAOGWithProcessRecording)

`<base>` is either a reference-style dump prefix or a scene XML (which
is then traced by `dump.trace_dump` to produce the dump — the
in-framework replacement for the external pathrenderer).  Tracing, the
k-NN search, the nearest-seed search and the aggregation run on
`--device` (default: the first CUDA device; without one the CLI raises
unless given `--device cpu`).

Outputs (writers ported from src/cluster.cpp:23-154):
  <base>_k-K_direct(.exr, _o.exr)    re-aggregated / original direct
  <base>_Le_init.exr                 original eLd per first hit
  <base>_k-K_full.exr                eLd + final MC estimate
  <base>_k-K_indirect(.exr,_pt,_blur) final MC / PT indirect / blurred
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from nori_tpu_torch.pathgraph.io import (
    load_path_graph, save_path_graph, load_neighbors, save_neighbors,
    PathGraphData,
)
from nori_tpu_torch.pathgraph.bsdfgraph import GraphPoints
from nori_tpu_torch.pathgraph.grid import UniformGrid, knn
from nori_tpu_torch.pathgraph.cluster import build_clusters, pad_clusters
from nori_tpu_torch.pathgraph import aggregate
from nori_tpu_torch.bitmap import write_exr
from nori_tpu_torch.device import resolve_device


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Stages:
    """Seconds per stage: each call closes the stage it names, after
    the device has finished the stage's work."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}
        self.t = time.time()

    def __call__(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def _splat_first_hits(g: PathGraphData, values):
    """Per-path first-vertex values -> (H, W, 3) image keyed by the
    cPath pixel indices (writeIndirectLight et al)."""
    img = np.zeros((g.yres, g.xres, 3), np.float32)
    has = g.paths["numOfPathPoints"] > 0
    x = g.paths["xIdx"][has]
    y = g.paths["yIdx"][has]
    pid = g.paths["firstPathPointIdx"][has].astype(np.int64)
    img[y, x] = values[pid]
    return img, has


def write_outputs(base: str, g: PathGraphData, k: int,
                  blur_results, mc_results, direct):
    # the dumps keep vertex self-emission out of eLd (it travels through
    # the MIS em-hit terms), so the display images add L_em explicitly
    lem = np.asarray(g.lps["L_em"], np.float32)
    eLd = np.asarray(g.sps["eLd"]) + lem
    eLi = np.asarray(g.sps["eLi"]) + lem
    mc = _host(mc_results[-1])
    blur = _host(blur_results[-1])
    direct = _host(direct)

    img, has = _splat_first_hits(g, direct)
    write_exr(base + f"_k-{k}_direct.exr", img)
    img, _ = _splat_first_hits(g, eLd)
    write_exr(base + f"_k-{k}_direct_o.exr", img)

    # Le_init / full include the background emission for zero-length
    # paths (writeFullinit/writeFullLight, src/cluster.cpp:62-103)
    img, _ = _splat_first_hits(g, eLd)
    bg = ~ (g.paths["numOfPathPoints"] > 0)
    img[g.paths["yIdx"][bg], g.paths["xIdx"][bg]] = g.paths["em"][bg]
    write_exr(base + "_Le_init.exr", img)

    img, _ = _splat_first_hits(g, eLd + mc)
    img[g.paths["yIdx"][bg], g.paths["xIdx"][bg]] = g.paths["em"][bg]
    write_exr(base + f"_k-{k}_full.exr", img)

    img, _ = _splat_first_hits(g, mc)
    write_exr(base + f"_k-{k}_indirect.exr", img)
    img, _ = _splat_first_hits(g, eLi - eLd)
    write_exr(base + f"_k-{k}_indirect_pt.exr", img)
    img, _ = _splat_first_hits(g, blur)
    write_exr(base + f"_k-{k}_indirect_blur.exr", img)


def run(base: str, k: int = 16, iterations: int = 1, mode: str = "opt",
        save_dump: bool = False, dump_depth: int = 8, verbose=True,
        device=None, times: dict | None = None):
    """Load or trace a dump, aggregate it in `mode` and write the seven
    images of write_outputs, on `device` (default: the first CUDA
    device; device.resolve_device).  Returns (PathGraphData, blur
    results, mc results, direct), the last three tensors on the device.
    `times`, when given, receives the seconds of each stage."""
    dev = resolve_device(device)
    stages = _Stages(dev)
    if base.endswith(".xml"):
        from nori_tpu_torch import load_from_xml
        from nori_tpu_torch.pathgraph.dump import trace_dump

        scene = load_from_xml(base)
        if verbose:
            print(f"[pg] tracing dump from {base}")
        g = trace_dump(scene, max_depth=dump_depth, device=dev)
        base = os.path.splitext(base)[0]
        if save_dump:
            save_path_graph(base, g)
        stages("dump")
    else:
        g = load_path_graph(base)
        stages("load")
    if verbose:
        print(f"[pg] {g.num_points} shading points, {len(g.paths)} paths, "
              f"{g.xres}x{g.yres}")

    gp = GraphPoints(g.sps, dev)
    pos = np.asarray(g.sps["pos"])
    dims = g.grid_dimensions()

    if mode == "knn":
        grid = UniformGrid(pos, dims, g.aabb_min, g.aabb_max)
        neighbors, counts = knn(pos, grid, k, device=dev)
        stages("grid and knn")
        if verbose:
            print(f"[pg] knn built (k={k})")
        blur, mc = aggregate.iterate_knn(gp, neighbors, iterations,
                                         timer=stages)
        direct = gp.eLd
    else:
        if mode == "l":
            cluster_id, offsets = load_neighbors(base)
            order = np.argsort(cluster_id, kind="stable").astype(np.int32)
            offsets = np.concatenate(
                [offsets, [len(cluster_id)]]).astype(np.int32)
        else:
            cluster_id, order, offsets = build_clusters(
                pos, dims, g.aabb_min, g.aabb_max, k, device=dev)
            if save_dump:
                save_neighbors(base, cluster_id, offsets[:-1])
        stages("grid and clusters")
        if verbose:
            print(f"[pg] {len(offsets) - 1} clusters "
                  f"(max size {np.diff(offsets).max()})")
        gp.groupIdx = torch.as_tensor(cluster_id, dtype=torch.int32,
                                      device=dev)
        members, sizes = pad_clusters(order, offsets, pad=2 * k)
        # "l" runs the loaded clusters through the recording scatter
        # driver, exactly like the reference's loadClusterScatter
        cluster_mode = "t" if mode == "l" else mode
        blur, mc, direct = aggregate.iterate_cluster(
            gp, g.lps, members, sizes, cluster_id, iterations,
            mode=cluster_mode, timer=stages)

    write_outputs(base, g, k, blur, mc, direct)
    stages("write")
    if verbose:
        print(f"[pg] wrote {base}_k-{k}_* images")
        print("[pg] seconds: " + ", ".join(
            f"{name} {sec:.2f}" for name, sec in stages.seconds.items()))
    if times is not None:
        times.update(stages.seconds)
    return g, blur, mc, direct


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pg")
    ap.add_argument("base", help="dump prefix or scene .xml")
    ap.add_argument("-k", type=int, default=16)
    ap.add_argument("-i", "--iterations", type=int, default=1)
    ap.add_argument("-m", "--mode", default="opt",
                    choices=["opt", "n", "t", "l", "knn"])
    ap.add_argument("--save-dump", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    run(args.base, args.k, args.iterations, args.mode, args.save_dump,
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
