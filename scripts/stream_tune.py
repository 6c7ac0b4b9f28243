#!/usr/bin/env python3
"""Time variants of the streamed sweep (K5, K5-cull) and the 2-D sweep
(K6) on one CUDA card.

    python3 scripts/stream_tune.py [S,MS,SHARE[,BLOCKS[,G[,PAD]]] ...]

Each variant is this checkout's csrc/ copied to a temporary directory
with STREAM_S = S and MT_S = MS (csrc/common.cuh: keys per chunk of K5's
work items, positions per chunk of K6's), for SHARE = 0 without the
walks' call of share_best (an item then shares its rays' packed best
only at its start and end, not after every quarter), for BLOCKS > 0
the two work-item kernels declared __launch_bounds__(TILE_N, BLOCKS),
so that the compiler fits that many blocks on one SM, K5's gate on
sub-blocks of STREAM_G = G triangles (default 32; the boxes are built
at G for the variant) widened by GATE_PAD = 2^-PAD (default 12); built
there and loaded in place of the checkout's kernels.  On the ajax
stand-in (chip_smoke.ajax_scene): K5 BW closest, MT closest, BW any-hit
and K5-cull MT closest at 32,768 check rays; K5 BW closest on the
131,072 camera rays of one whitted batch and BW any-hit on its shadow
rays as traverse.occluded sorts them; K5 BW closest and any-hit on the
bounce and shadow rays of one steady cbox_scan step at 524,288 lanes
(stream_inputs.cbox_scan_inputs).  On the living room's 131,072 check
rays: K6 culled, closest and any-hit.  Each variant must give the
checkout's own build's answers (closest: equal triangles and t bits, K6
also u and v; any-hit: equal hit masks); each query is timed (CUDA
events, mean of 10 launches after a warm-up), its visits are summed
(groups of 512 triangles per ray tile: K5's warp sub-blocks of G count
G / 4096 each, K6's quarter tiles 1/4) and K5's gate tally is read
(the warp sub-blocks tested and skipped).  Prints one JSON line per
variant, with the number of kernels ptxas reports spills for in that
variant's build.
Default variants: 2,4,1,0,16 2,4,1,0,32 2,4,1,0,64.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_variant(orig: str, s: int, ms: int, share: int, blocks: int,
                  g: int, pad: int, tmp: str):
    """Build and load a copy of csrc/ with STREAM_S s, MT_S ms, the
    walks sharing the packed best after every quarter or (share 0) not,
    the work-item kernels bounded to `blocks` blocks per SM (0:
    unbounded), STREAM_G g and GATE_PAD 2^-pad.  Returns the build's
    compiler output."""
    from nori_tpu_torch import cuda_build

    src = os.path.join(tmp, f"csrc_{s}_{ms}_{share}_{blocks}_{g}_{pad}")
    if not os.path.isdir(src):
        shutil.copytree(orig, src, ignore=shutil.ignore_patterns("_build"))
        edits = {"common.cuh": [
            (r"#define STREAM_S \d+", f"#define STREAM_S {s}"),
            (r"#define MT_S \d+", f"#define MT_S {ms}"),
            (r"#define STREAM_G \d+", f"#define STREAM_G {g}"),
            (r"#define GATE_PAD 0x1p-\d+f", f"#define GATE_PAD 0x1p-{pad}f")],
            "stream_sweep.cu": [], "mt_sweep.cu": []}
        for name, kernel in (("stream_sweep.cu", "stream_sweep_items"),
                             ("mt_sweep.cu", "mt_sweep_items")):
            if not share:
                edits[name].append((r"\n +share_best\([^;]*;", "\n"))
            if blocks:
                edits[name].append((
                    rf"__global__ void (?={kernel}\()",
                    f"__global__ void __launch_bounds__(TILE_N, {blocks}) "))
        for name, subs in edits.items():
            path = os.path.join(src, name)
            with open(path) as f:
                txt = f.read()
            for pat, new in subs:
                txt, n = re.subn(pat, new, txt)
                if n != 1:
                    raise RuntimeError(f"{name}: {pat!r} matched {n} times")
            with open(path, "w") as f:
                f.write(txt)
    cuda_build.CSRC = src
    cuda_build.BUILD_DIR = os.path.join(src, "_build")
    cuda_build._lib = None
    cuda_build.build_log = ""   # stays empty if this variant was built before
    cuda_build.load()
    return cuda_build.build_log


def same(got, ref, any_hit: bool) -> bool:
    """Does a variant's answer equal the reference build's?"""
    import torch

    if any_hit:
        return bool(torch.equal(got[1] >= 0, ref[1] >= 0))
    hit = ref[1] >= 0
    return (torch.equal(got[1], ref[1]) and all(
        torch.equal(g[hit].view(torch.int32), r[hit].view(torch.int32))
        for g, r in zip(got, ref)))


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep
    from stream_inputs import ajax_inputs, cbox_scan_inputs, room_inputs

    variants = [(tuple(int(x) for x in a.split(",")) + (0, 32, 12)[
        max(0, len(a.split(",")) - 3):])[:6]
        for a in (sys.argv[1:] or ["2,4,1,0,16", "2,4,1,0,32",
                                   "2,4,1,0,64"])]
    dev = torch.device("cuda:0")
    print(cs.card_line())
    cs.build_kernels()
    orig, g0 = cuda_build.CSRC, sweep.STREAM_G

    a = ajax_inputs(cs, dev)
    asd, tb, rays = a.sd, a.sd.tri_tile_bounds, a.rays
    c = cbox_scan_inputs(dev)
    room = room_inputs(cs, dev)
    rsd = room.sd
    # the gate's boxes of each streamed scene at the variant's G
    boxes = {}

    def set_g(g):
        sweep.STREAM_G = g
        boxes["ajax"] = sweep.stream_sub_boxes(asd.tri_packed, g)
        boxes["cbox_scan"] = sweep.stream_sub_boxes(c.sd.tri_packed, g)

    # {label: (call(visits, tally), rays, any-hit, 512-triangle slabs per
    # counted visit)}
    calls = {}
    k5_per = lambda: sweep.STREAM_G / (512 * 8)   # noqa: E731
    for label, sd, op, use_bw, r, ah in (
            ("32768 bw closest", "ajax", asd.tri_bw, True, rays, False),
            ("32768 mt closest", "ajax", asd.tri_packed, False, rays, False),
            ("32768 bw any-hit", "ajax", asd.tri_bw, True, a.shadow, True),
            ("131072 bw closest", "ajax", asd.tri_bw, True, a.rays_b, False),
            ("131072 bw any-hit sorted", "ajax", asd.tri_bw, True, a.srt,
             True),
            ("cbox_scan step bw closest", "cbox_scan", c.sd.tri_bw, True,
             c.closest, False),
            ("cbox_scan step bw any-hit", "cbox_scan", c.sd.tri_bw, True,
             c.shadow, True)):
        kb = sweep.ray_tile_entry_keys(
            (asd if sd == "ajax" else c.sd).tri_tile_bounds, r)
        calls[label] = (
            lambda v=None, tally=None, sd=sd, op=op, kb=kb, r=r, ah=ah,
            use_bw=use_bw: sweep.stream_sweep(
                op, *kb, r, ah, use_bw, visits=v, sub_boxes=boxes[sd],
                tally=tally), r, ah, k5_per)
    kb = sweep.ray_tile_entry_keys(tb, rays)
    calls["32768 cull mt closest"] = (
        lambda v=None, tally=None, kb=kb: sweep.stream_sweep_culled(
            asd.tri_packed, *kb, rays, False, cs.CULL_T, visits=v,
            tally=tally), rays, False, k5_per)
    for label, r, ah in (("k6 closest", room.rays, False),
                         ("k6 any-hit", room.shadow, True)):
        calls[label] = (
            lambda v=None, tally=None, r=r, ah=ah: sweep.mt_sweep(
                rsd.tri_packed, rsd.tri_tile_bounds, rsd.scene_bounds, r,
                any_hit=ah, visits=v), r, ah,
            lambda: sweep.TILE_U / sweep.TILE_T)
    set_g(g0)
    ref = {k: fn() for k, (fn, *_) in calls.items()}
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        for s, ms, share, blocks, g, pad in variants:
            t0 = time.time()
            log = build_variant(orig, s, ms, share, blocks, g, pad, tmp)
            set_g(g)
            row = dict(S=s, MT_S=ms, share=share, blocks=blocks, G=g,
                       pad=pad, build_s=time.time() - t0)
            spills = [ln.strip() for ln in log.splitlines()
                      if "spill" in ln and "0 bytes spill stores, 0 bytes"
                      not in ln]
            # null: served from an earlier build of the same variant
            row["spilling_kernels"] = len(spills) if log else None
            for label, (fn, r, ah, per) in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if not same(got, ref[label], ah):
                    raise AssertionError(f"variant {s},{ms},{share},{blocks},"
                                         f"{g},{pad}: {label} differs from "
                                         "the checkout's build")
                visits = cs.sweep_visits(fn, r)
                row[label] = dict(
                    ms=cs.time_ms(fn, 10),
                    per_ray_tile=float(visits.double().mean()) * per())
                if "k6" not in label:
                    row[label]["gate"] = cs.gate_tally(fn)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
