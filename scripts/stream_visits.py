#!/usr/bin/env python3
"""Visits per ray tile of the streamed sweep (K5, K5-cull) and the 2-D
sweep (K6) on one CUDA card.

    python3 scripts/stream_visits.py [ROOT]

With the kernels of the checkout at ROOT (default: this one):

* on the ajax stand-in (chip_smoke.ajax_scene, 541,696 triangles in
  1,058 slabs), at chip_smoke's 32,768 check rays: K5 BW closest, MT
  closest, BW any-hit, K5-cull closest and any-hit; and K5 BW any-hit
  on the 131,072 shadow rays of one whitted batch, in the order
  traverse.occluded sorts them and unsorted;
* on the benchmark's cbox_scan, K5 BW closest and any-hit on one steady
  524,288-lane step's bounce and sorted shadow rays
  (stream_inputs.cbox_scan_inputs);
* on the living room (chip_smoke FULL) at 131,072 check rays: K6
  culled, closest and any-hit.

One JSON line per query: the launch time (CUDA events,
chip_smoke.time_ms), the distribution of the kernel's visit counts over
ray tiles (mean, p50, p99, max, the ray tiles above 4x the mean, the 24
largest), the triangles per counted visit (`group`: a checkout may
count slabs, quarter slabs or sub-blocks, and a gated one each warp's
sub-blocks of STREAM_G), K5's gate tally where the checkout has the
gate (`gate`: warp sub-blocks tested, and skipped while a ray of the
warp searched), the candidate keys per row,
the share of all visits that lie beyond c visits of their row for caps
c of a first pass (given in slabs or tiles of 512 triangles), and the
work items the plan left to the persistent blocks where the checkout
has them.  Before
them: what ptxas reports for each streamed and 2-D kernel (registers,
spills, shared memory) and the blocks of 256 threads one SM holds by
that count (65,536 registers, 227 KB of shared memory, 2,048 threads).
Needs of ROOT's chip_smoke only what every version since the streamed
path has (FULL, CHECK_LANES, AJAX_*, ajax_scene, ajax_rays,
wavefront_rays, time_ms, build_kernels, card_line), so it runs on older
checkouts too.
"""

from __future__ import annotations

import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
sys.path.insert(0, ROOT)

#: caps of a first pass, in visits of 512 triangles
CAPS = (1, 2, 4, 8, 16, 32)


def visit_stats(visits) -> dict:
    """As chip_smoke.visit_stats: mean, p50, p99, max, the ray tiles
    above 4x the mean."""
    v = visits.double().cpu()
    mean = float(v.mean())
    return dict(mean=mean, p50=float(v.quantile(0.5)),
                p99=float(v.quantile(0.99)), max=int(v.max()),
                over_4x_mean=int((v > 4 * mean).sum()), ray_tiles=v.numel())


def beyond(visits, per_512: int) -> dict:
    """{cap: (ray tiles over it, share of all visits past it)}, the cap
    in visits of 512 triangles (per_512 counted visits each)."""
    v = visits.long().cpu()
    tot = max(int(v.sum()), 1)
    return {c: (int((v > c * per_512).sum()),
                float((v - c * per_512).clamp_min(0).sum()) / tot)
            for c in CAPS}


def ptxas_report(log: str, dynamic_smem) -> list[dict]:
    """Per streamed or 2-D sweep kernel in an nvcc -Xptxas -v log:
    registers, spill bytes, static shared memory, and the 256-thread
    blocks one SM holds.  dynamic_smem(name) gives the bytes the launch
    adds."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if not (m and name and ("stream" in name or "mt_sweep" in name)):
            continue
        regs = int(m.group(1))
        s = re.search(r"(\d+) bytes smem", line)
        smem = (int(s.group(1)) if s else 0) + dynamic_smem(name)
        blocks = min(65536 // (max(regs, 1) * 256),
                     (227 * 1024) // (smem + 1024), 8)
        rows.append(dict(kernel=name, registers=regs, spill_bytes=spill,
                         smem_bytes=smem, blocks_per_sm=blocks))
    return rows


def run_query(cs, label, lanes, call, rays, keys_bits, group, per_512,
              items=None, gated=False):
    """Time one query, read its visits and print its JSON line.
    call(visits) launches it; items() reads the tail's work items; a
    gated call (call(visits, tally)) also reads its gate's tally: the
    warp sub-blocks tested and those skipped while a ray searched."""
    import torch

    visits = torch.zeros(rays.shape[1] // 256, dtype=torch.int32,
                         device=rays.device)
    call(visits)
    torch.cuda.synchronize()
    row = dict(lanes=lanes, query=label, ms=cs.time_ms(lambda: call(None)),
               group=group, visits=visit_stats(visits),
               beyond=beyond(visits, per_512),
               largest=sorted(visits.cpu().tolist())[-24:])
    if items is not None:
        row["work"] = items()
    if gated:
        tally = torch.zeros((2,), dtype=torch.int64, device=rays.device)
        call(None, tally)
        tested, culled = tally.tolist()
        row["gate"] = dict(tested=tested, culled=culled,
                           culled_share=culled / max(tested + culled, 1))
    if keys_bits is not None:
        keys, bits = keys_bits
        cand = ((keys & ~((1 << bits) - 1)) < 0x7F800000).sum(1)
        row.update(candidates_mean=float(cand.double().mean()),
                   candidates_max=int(cand.max()))
    print(json.dumps(row), flush=True)


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep
    from nori_tpu_torch.render import DEFAULT_BATCH
    from stream_inputs import (ajax_inputs, cbox_scan_inputs, gate_kw,
                               room_inputs)

    dev = torch.device("cuda:0")
    print(cs.card_line(), ROOT)
    cs.build_kernels()
    # a one-pass checkout stages whole slabs in dynamic shared memory
    two_pass = hasattr(sweep, "stream_workspace")

    def dynamic_smem(name: str) -> int:
        if two_pass or "stream" not in name:
            return 0
        return 2 * (12 if "ILb1E" in name else 9) * 512 * 4

    if not cuda_build.build_log:
        print("ptxas: the kernels were built before this run; no "
              "compiler log")
    for r in ptxas_report(cuda_build.build_log, dynamic_smem):
        print(json.dumps(r), flush=True)
    # triangles per counted visit of K5 (a quarter slab or, gated, one
    # warp's sub-block) and of K6
    gated = hasattr(sweep, "STREAM_G")
    unit = (sweep.STREAM_G if gated
            else getattr(sweep, "STREAM_U", sweep.STREAM_T))
    unit6 = getattr(sweep, "TILE_U", sweep.TILE_T)
    # counted visits per 512-triangle slab of a ray tile
    per5 = 512 // unit * (8 if gated else 1)

    def stream_queries(lanes, cases, with_cull):
        for label, op, use_bw, r, any_hit in cases:
            kb = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, r)
            ws = sweep.stream_workspace(r.shape[1], dev) if two_pass else None
            kw = dict(workspace=ws, **gate_kw(sd)) if two_pass else {}
            items = ((lambda ws=ws, r=r: sweep.stream_work(ws, r.shape[1]))
                     if two_pass else None)
            run_query(cs, "K5 " + label, lanes,
                      lambda v, tally=None, op=op, kb=kb, r=r,
                      any_hit=any_hit, use_bw=use_bw, kw=kw:
                      sweep.stream_sweep(
                          op, *kb, r, any_hit, use_bw, visits=v,
                          **(dict(kw, tally=tally) if gated else kw)),
                      r, kb, unit, per5, items, gated)
            if with_cull and not use_bw:
                kw = {k: v for k, v in kw.items() if k != "sub_boxes"}
                run_query(cs, "K5-cull " + label, lanes,
                          lambda v, tally=None, op=op, kb=kb, r=r,
                          any_hit=any_hit, kw=kw: sweep.stream_sweep_culled(
                              op, *kb, r, any_hit, cs.CULL_T, visits=v,
                              **(dict(kw, tally=tally) if gated else kw)),
                          r, kb, unit if gated else cs.CULL_T,
                          per5 if gated else 512 // cs.CULL_T, items, gated)

    a = ajax_inputs(cs, dev)
    sd = a.sd
    stream_queries(cs.AJAX_CHECK_LANES, (
        ("bw closest", sd.tri_bw, True, a.rays, False),
        ("mt closest", sd.tri_packed, False, a.rays, False),
        ("bw any-hit", sd.tri_bw, True, a.shadow, True),
        ("mt any-hit", sd.tri_packed, False, a.shadow, True)), True)
    stream_queries(DEFAULT_BATCH, (
        ("bw any-hit sorted", sd.tri_bw, True, a.srt, True),
        ("bw any-hit unsorted", sd.tri_bw, True, a.shadow_b, True)), False)
    del a
    c = cbox_scan_inputs(dev)
    sd = c.sd
    stream_queries(c.closest.shape[1], (
        ("cbox_scan step bw closest", sd.tri_bw, True, c.closest, False),
        ("cbox_scan step bw any-hit", sd.tri_bw, True, c.shadow, True)),
        False)
    del c

    room = room_inputs(cs, dev)
    sd, rays, shadow = room.sd, room.rays, room.shadow
    args = (sd.tri_packed, sd.tri_tile_bounds, sd.scene_bounds)
    for label, r, any_hit in (("closest", rays, False),
                              ("any-hit", shadow, True)):
        ws = sweep.stream_workspace(r.shape[1], dev) if two_pass else None
        kw = dict(workspace=ws) if two_pass else {}
        items = ((lambda ws=ws, r=r: sweep.stream_work(ws, r.shape[1]))
                 if two_pass else None)
        run_query(cs, "K6 culled " + label, cs.CHECK_LANES,
                  lambda v, r=r, any_hit=any_hit, kw=kw: sweep.mt_sweep(
                      *args, r, any_hit=any_hit, visits=v, **kw),
                  r, None, unit6, 512 // unit6, items)
    return 0


if __name__ == "__main__":
    sys.exit(main())
