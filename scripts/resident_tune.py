#!/usr/bin/env python3
"""Time variants of the two-pass resident sweep on one CUDA card.

    python3 scripts/resident_tune.py [V,S,U ...]

Each variant V,S,U is this checkout's csrc/ copied to a temporary
directory with RESIDENT_V = V and RESIDENT_S = S (csrc/common.cuh) and
the pair loop of resident_sweep.cu unrolled U times (1: not unrolled),
built there and loaded in place of the checkout's kernels.  On the
living room's wavefront rays (chip_smoke FULL after two steps) at
131,072 and 524,288 lanes, each variant must give the checkout's own
build's answers (closest: equal triangles and t bits; any-hit: equal
hit masks), and its K2 BW closest, K2 BW any-hit, K4 and K2-mxu are
timed (CUDA events, mean of 10 launches after a warm-up).  Prints one
JSON line per variant.  Default variants: 16,8,1 8,8,8 4,4,8 2,2,8.
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


def build_variant(orig: str, v: int, s: int, u: int, tmp: str):
    """Build and load csrc/ with RESIDENT_V v, RESIDENT_S s, unroll u."""
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep

    src = os.path.join(tmp, f"csrc_{v}_{s}_{u}")
    shutil.copytree(orig, src, ignore=shutil.ignore_patterns("_build"))
    path = os.path.join(src, "common.cuh")
    with open(path) as f:
        txt = f.read()
    txt = re.sub(r"#define RESIDENT_V \d+", f"#define RESIDENT_V {v}", txt)
    txt = re.sub(r"#define RESIDENT_S \d+", f"#define RESIDENT_S {s}", txt)
    with open(path, "w") as f:
        f.write(txt)
    path = os.path.join(src, "resident_sweep.cu")
    with open(path) as f:
        txt = f.read()
    txt, n = re.subn(r"#pragma unroll \d+(\n\s+for \(int c = 0; c < FINE_T)",
                     rf"#pragma unroll {u}\1", txt)
    if n != 1:
        raise RuntimeError("resident_sweep.cu: the pair loop's unroll "
                           "pragma was not found")
    with open(path, "w") as f:
        f.write(txt)
    cuda_build.CSRC = src
    cuda_build.BUILD_DIR = os.path.join(src, "_build")
    cuda_build._lib = None
    sweep.RESIDENT_V, sweep.RESIDENT_S = v, s
    cuda_build.load()


def same(q: str, n: int, got, ref) -> bool:
    """Does a variant's answer equal the reference build's?"""
    import torch

    (gt, gi), (rt, ri) = got, ref
    if q == "bw any-hit":
        return bool(torch.equal(gi >= 0, ri >= 0))
    if q == "k4":
        return (torch.equal(gi[:n], ri[:n])
                and torch.equal(gt[:n].view(torch.int32),
                                rt[:n].view(torch.int32))
                and torch.equal(gi[n:] >= 0, ri[n:] >= 0))
    return (torch.equal(gi, ri)
            and torch.equal(gt.view(torch.int32), rt.view(torch.int32)))


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.scenes_builtin import living_room

    variants = [tuple(int(x) for x in a.split(","))
                for a in (sys.argv[1:] or ["16,8,1", "8,8,8", "4,4,8",
                                           "2,2,8"])]
    dev = torch.device("cuda:0")
    print(cs.card_line())
    cs.build_kernels()
    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    calls = {}
    for lanes in (cs.CHECK_LANES, cfg["n_lanes"]):
        r, s = cs.wavefront_rays(scene, sd, dev, lanes)
        both = torch.cat([r, s], dim=1).contiguous()
        flags = (torch.arange(both.shape[1] // 256, device=dev)
                 >= lanes // 256).to(torch.int32)
        kc = sweep.ray_tile_entry_keys(tb, r)
        ks = sweep.ray_tile_entry_keys(tb, s)
        kb = sweep.ray_tile_entry_keys(tb, both)
        calls[(lanes, "bw closest")] = lambda kc=kc, r=r: \
            sweep.resident_sweep(sd.tri_bw, *kc, r)
        calls[(lanes, "bw any-hit")] = lambda ks=ks, s=s: \
            sweep.resident_sweep(sd.tri_bw, *ks, s, True)
        calls[(lanes, "k4")] = lambda kb=kb, b=both, f=flags: \
            sweep.resident_sweep_mixed(sd.tri_bw, *kb, b, f)
        calls[(lanes, "mxu")] = lambda kc=kc, r=r: \
            sweep.resident_sweep_mxu(sd.tri_mxu, *kc, r)
    ref = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    orig = cuda_build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for v, s, u in variants:
            t0 = time.time()
            build_variant(orig, v, s, u, tmp)
            row = dict(V=v, S=s, unroll=u, build_s=time.time() - t0)
            for (lanes, q), fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if not same(q, lanes, got, ref[(lanes, q)]):
                    raise AssertionError(f"variant {v},{s},{u}: {lanes} {q} "
                                         "differs from the checkout's build")
                row[f"{lanes} {q}"] = cs.time_ms(fn, 10)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
