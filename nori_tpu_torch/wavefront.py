"""Persistent-wavefront path tracing with lane regeneration.

Port of `nori_tpu/wavefront.py`.  A fixed pool of N lanes processes a
chunk of Q sample work items; whenever a lane's path terminates it
pulls the next work item (a new camera ray) from a device-side counter,
so the intersection sweeps run near full occupancy.  Work item q
renders sample (q % spp) of pixel (q // spp).

Each step: one path vertex (integrators.path.path_vertex: closest-hit
sweep, emitter hit with MIS, next-event estimation with a shadow query,
Russian roulette and BSDF sampling), regeneration, then a coherence
sort of the lanes by their candidate triangle tiles.  Terminated
lanes' (q, L) records go densely into a per-chunk record log at a
running cursor; after the chunk drains, one sort by q restores sample
order for the dense film splat.

The merged step (config.MERGED_SWEEP; NEE modes on resident scenes)
traces, after the sort, the next bounce's closest hits and this step's
shadow rays in one mixed sweep (traverse.intersect_mixed, kernel K4),
applies the pending NEE contribution to the permuted lanes and record
rows, and carries the hits into the next step.  The first step of a
chunk primes them with one closest sweep.  Sample values are the
two-launch step's, bit for bit.

Determinism: lanes key the counter-based RNG by global sample id q, so
a sample's value does not depend on lane order or pool width.

Work item ids are uint32 in the JAX package; here they are int64
tensors holding uint32 values, masked where a uint32 would wrap.  The
state carried between steps is a dict of tensors; `step` returns a new
one and writes the chunk's record log in place (the JAX package
donates it).  Nothing in a step reads a device value on the host or
copies a host value to the device, so the host runs ahead of the card
(the random streams fold their Python-int seeds and stream ids on the
host, core/rng.py).

CUDA graphs: on a CUDA device with the sweep backend
(graphs.graph_replay), a stage's step is captured once as a CUDA graph
over a static carry and replayed (_GraphedStep): run_chunk's window of
CHECK_EVERY steps is then CHECK_EVERY graph launches, the same kernels
in the same order, so the samples are the eager step's bit for bit.
The first step of each stage in each chunk runs eagerly (it warms the
stage, and primes a merged chunk).  A render captures its own graphs
and releases them when it returns (release_graphs).
"""

from __future__ import annotations

import hashlib
import math
import os
import time
import zipfile

import numpy as np
import torch

from nori_tpu_torch import config, graphs, spans
from nori_tpu_torch.bitmap import write_png
from nori_tpu_torch.accel.sweep import lane_keys, pack_rays
from nori_tpu_torch.accel.traverse import (
    count_gate_tally, intersect, intersect_mixed, sweep_hit_epilogue)
from nori_tpu_torch.bsdf import E_DISCRETE
from nori_tpu_torch.core import rng
from nori_tpu_torch.core.vecmath import EPSILON, to_world
from nori_tpu_torch.device import resolve_device
from nori_tpu_torch.integrators.path import EMS, MIS, path_vertex
from nori_tpu_torch.render import (
    JITTER_STREAM, Solo, _PendingCount, prepare)

MAX_DEPTH = 48
#: the host reads the pool's occupancy every this many steps, one
#: window late, so the read never waits for the steps just enqueued
CHECK_EVERY = 8
#: when occupancy falls to n_lanes/SHRINK_FACTOR the pool is packed into
#: a SHRINK_FACTOR-x narrower stepper, so the drain tail does not pay
#: full-width sweeps
SHRINK_FACTOR = 8
MAX_SHRINK_STAGES = 2

#: sort keys: survivors' key words stay < 2^30; idle lanes sort after
#: every survivor and done lanes last, so the flipped record window
#: starts with the real records
KEY_IDLE = 0x7FFFFFFD
KEY_DONE = 0x7FFFFFFE
#: record-log q for rows that carry no sample
REC_SENTINEL = 0xFFFFFFFF
_M32 = 0xFFFFFFFF


def _u32_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> float32 carrying the same bits."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32).view(
        torch.float32)


def _f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def _pack_state(st, rec_q, rec_l):
    """State dict (+ record columns) -> (N, 23) float32 matrix, so the
    coherence sort permutes the whole state with one row gather."""
    f32 = torch.float32
    cols = [
        _u32_to_f32(st["q"])[:, None],
        st["depth"].view(f32)[:, None],
        st["active"].to(f32)[:, None],
        st["spec"].to(f32)[:, None],
        st["prev_pdf"][:, None],
        st["mint"][:, None],
        st["maxt"][:, None],
        st["o"], st["d"], st["beta"], st["L"],
        _u32_to_f32(rec_q)[:, None],
        rec_l,
    ]
    return torch.cat(cols, dim=1)


def _unpack_state(m, q0):
    return dict(
        q=_f32_to_u32(m[:, 0]),
        depth=m[:, 1].contiguous().view(torch.int32),
        active=m[:, 2] > 0.5,
        spec=m[:, 3] > 0.5,
        prev_pdf=m[:, 4],
        mint=m[:, 5],
        maxt=m[:, 6],
        o=m[:, 7:10], d=m[:, 10:13], beta=m[:, 13:16], L=m[:, 16:19],
        q0=q0,
    )


def key_coarsen(n_rows: int, n_tt: int) -> int:
    """Sort-key tile grouping for a scene whose triangle operand has
    n_rows rows and whose tile bounds n_tt boxes: the factor pinned by
    config.SORT_KEY_COARSEN if there is one (wavefront.py:200-203), else
    the JAX package's factors (auto_key_coarsen, wavefront.py:119-130),
    8 for streamed scenes (16-row operands), 4 above 256 tiles, else 1.
    Kept for key parity; parameters to re-measure on the H100, not
    Hopper measurements."""
    if config.SORT_KEY_COARSEN is not None:
        return max(1, int(config.SORT_KEY_COARSEN))
    if n_rows == 16:
        return 8
    return 4 if n_tt > 256 else 1


def _coarsen_bounds(kb, c: int):
    """Group (n_tt, 8) tile boxes c at a time (the last group takes the
    remainder), as wavefront.py:484-498."""
    n_tt = kb.shape[0]
    ng = n_tt // c
    head = kb[:ng * c].reshape(ng, c, 8)
    parts = [torch.cat([torch.amin(head[:, :, 0:3], dim=1),
                        torch.amax(head[:, :, 3:6], dim=1),
                        torch.zeros((ng, 2), dtype=kb.dtype,
                                    device=kb.device)], dim=1)]
    if n_tt % c:
        tail = kb[ng * c:]
        parts.append(torch.cat([
            torch.amin(tail[:, 0:3], dim=0, keepdim=True),
            torch.amax(tail[:, 3:6], dim=0, keepdim=True),
            torch.zeros((1, 2), dtype=kb.dtype, device=kb.device)], dim=1))
    return torch.cat(parts, dim=0).contiguous()


def merged_step(scene, mode: int, merged: bool | None = None) -> bool:
    """Does the wavefront take the merged step?  merged (None reads
    config.MERGED_SWEEP), for NEE modes on resident-layout scenes only
    (wavefront.py:196-199)."""
    if merged is None:
        merged = config.MERGED_SWEEP
    return bool(merged) and mode in (EMS, MIS) and \
        scene.compile_arrays()["tri_packed"].shape[0] != 16


class _GraphedStep:
    """A stage's step(sd, carry, seed), replayed as a CUDA graph.

    On a carry that is not the stage's static carry (one from init or
    from a shrink), the step runs eagerly and its result is written into
    the static carry, which it becomes the first time.  On the static
    carry, the first call captures one step that reads the static carry
    and ends in copies of the new carry into it (capture runs nothing),
    and every call replays that graph: one replay advances the pool by
    one step in place, and returns the static carry.  A new sd or seed
    captures again.  A replay counts the launches and spans' counters of
    one step (graphs.StaticCarry).
    """

    def __init__(self, step, device):
        self._step, self._device = step, device
        self._static = graphs.StaticCarry(device)
        self.release()

    def __call__(self, sd, carry, seed):
        static = self._static
        if carry is not static.carry:
            return static.keep(self._step(sd, carry, seed))
        if sd is not self._sd or seed != self._seed:
            static.drop_graphs()
            self._sd, self._seed = sd, seed
        out = static.replay("step", lambda c: self._step(sd, c, seed))
        spans.count("steps.graphed")
        return out

    def record_log(self, rows: int):
        """The record log of the static carry, (rows, 4) int32, which
        every chunk's init refills (a graph writes the log it was
        captured on)."""
        if self._log is None:
            self._log = torch.empty((rows, 4), dtype=torch.int32,
                                    device=self._device)
        return self._log

    def release(self):
        """Reset the graph and drop the static carry and record log."""
        self._static.release()
        self._log = self._sd = self._seed = None


def release_graphs(steppers):
    """Release the CUDA graphs of run_chunk's steppers (init, stages,
    finalize) and hand their memory pools back to the card."""
    graphed = [s for s, _, _ in steppers[1] if isinstance(s, _GraphedStep)]
    for s in graphed:
        s.release()
    if graphed:
        torch.cuda.empty_cache()


def make_wavefront_stepper(scene, mode: int, n_lanes: int, chunk: int,
                           max_depth: int = MAX_DEPTH,
                           sort_rays: bool | None = None,
                           device=None, merged: bool | None = None,
                           graph: bool | None = None):
    """Build (init, step, n_active, finalize) for one pool width, on
    `device` (default: the first CUDA device; device.resolve_device).

    carry = (state dict, next_q, records (chunk + N, 4), w_cursor,
    rays, q_hi), the scalars 0-d int64 tensors on `device`; work items
    q in [q0, q_hi).  records rows are [q-bits, L.rgb]; rows past the
    cursor are garbage that later windows overwrite.  merged: take the
    merged step (see merged_step); one render decides it once for
    every stage of its shrink cascade, since a shrunk carry inherits
    the wide stage's state.  The merged state also carries the next
    rays' hits (hit_t, hit_tri) and `primed`, a host-side bool: whether
    they were traced yet.  graph: replay the step as a CUDA graph
    (_GraphedStep; None reads graphs.graph_replay).
    """
    device = resolve_device(device)
    if graph is None:
        graph = graphs.graph_replay(device)
    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params(device)
    N = n_lanes
    merged = merged_step(scene, mode, merged)
    arrays = scene.compile_arrays()
    n_tt = int(arrays["tri_tile_bounds"].shape[0])
    kc = key_coarsen(arrays["tri_packed"].shape[0], n_tt)
    if sort_rays is None:
        # coherence sorting pays only when the sweep has enough
        # triangle tiles to prune
        sort_rays = n_tt >= 16
    lane_iota = torch.arange(N, dtype=torch.int64, device=device)
    # the boxes K3 takes its sort keys on depend on the scene alone:
    # grouped once, at the first step that sorts by them
    key_bounds = []

    def camera_ray(seed, q):
        pix = torch.clamp_max(q // spp, w * h - 1)
        jitter = rng.uniform2(seed, q, JITTER_STREAM)
        px = (pix % w).to(torch.float32)
        py = (pix // w).to(torch.float32)
        pos = torch.stack([px, py], dim=-1) + jitter
        return type(cam).sample_rays(cam_params, pos)

    def init(seed, q0: int, q_end: int):
        q_hi = torch.tensor(min(q0 + chunk, q_end), device=device)
        q = (q0 + lane_iota) & _M32
        active = q < q_hi
        o, d, mint, maxt = camera_ray(seed, q)
        mint = torch.where(active, mint, 1.0)
        maxt = torch.where(active, maxt, -1.0)
        state = dict(
            q=q, q0=torch.tensor(q0, device=device), active=active,
            depth=torch.zeros((N,), dtype=torch.int32, device=device),
            o=o, d=d, mint=mint, maxt=maxt,
            beta=torch.ones((N, 3), dtype=torch.float32, device=device),
            L=torch.zeros((N, 3), dtype=torch.float32, device=device),
            spec=torch.ones((N,), dtype=torch.bool, device=device),
            prev_pdf=torch.zeros((N,), dtype=torch.float32, device=device),
        )
        if merged:
            state["hit_t"] = torch.full((N,), float("inf"),
                                        dtype=torch.float32, device=device)
            state["hit_tri"] = torch.full((N,), -1, dtype=torch.int32,
                                          device=device)
            state["primed"] = False
        # q column = sentinel bits (int32 -1 == uint32 0xFFFFFFFF)
        if graph:
            records = step.record_log(chunk + N).zero_()
        else:
            records = torch.zeros((chunk + N, 4), dtype=torch.int32,
                                  device=device)
        records[:, 0] = -1
        records = records.view(torch.float32)
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return (state, torch.tensor(q0 + N, device=device), records,
                zero.clone(), zero.clone(), q_hi)

    def eager_step(sd, carry, seed):
        st, next_q, records, w_cur, rays, q_hi = carry
        q, active, depth = st["q"], st["active"], st["depth"]
        q0 = st["q0"]
        o, d, mint, maxt = st["o"], st["d"], st["mint"], st["maxt"]
        beta, L = st["beta"], st["L"]
        spec, prev_pdf = st["spec"], st["prev_pdf"]

        with spans.span("step.vertex"):
            rays = rays + active.sum()
            hit = None
            if merged:
                # the previous step's mixed sweep traced these rays; the
                # first step of a chunk primes with one closest sweep
                if st["primed"]:
                    hit_t, hit_tri = st["hit_t"], st["hit_tri"]
                else:
                    h = intersect(sd, o, d, mint, maxt)
                    hit_t = torch.where(h.valid, h.t, float("inf"))
                    hit_tri = torch.where(h.valid, h.tri, -1)
                rp_cur, _ = pack_rays(o, d, mint, maxt)
                hit = sweep_hit_epilogue(sd, rp_cur, hit_t, hit_tri, N)
            its, frame, s, L, beta, alive, n_shadow, deferred = \
                path_vertex(sd, mode, o, d, mint, maxt, active, depth,
                            beta, L, spec, prev_pdf, seed, q, hit=hit,
                            defer_shadow=merged)
            rays = rays + n_shadow
            alive = alive & (depth + 1 < max_depth)

        with spans.span("step.regen"):
            # ---- terminate ------------------------------------------
            done = active & ~alive
            # record columns captured BEFORE regeneration overwrites
            # q/L; other rows get the sentinel so garbage window rows
            # never collide with a real sample slot
            rec_q = torch.where(done, q, REC_SENTINEL)
            rec_l = torch.where(done[:, None], L, 0.0)
            n_flush = done.sum()

            # ---- regenerate -----------------------------------------
            done64 = done.to(torch.int64)
            ranks = torch.cumsum(done64, 0) - done64
            new_q = (next_q + ranks) & _M32
            next_q = (next_q + n_flush) & _M32
            regen = done & (new_q < q_hi)
            q = torch.where(done, new_q, q)
            active = torch.where(done, regen, active)

            co, cd, cmint, cmaxt = camera_ray(seed, q)
            o = torch.where(regen[:, None], co, its.p)
            d = torch.where(regen[:, None], cd, to_world(frame, s.wo))
            mint = torch.where(regen, cmint, EPSILON)
            maxt = torch.where(regen, cmaxt, 1e30)
            # idle lanes get an empty interval so they do not widen the
            # sweep's per-ray-tile candidate lists
            mint = torch.where(active, mint, 1.0)
            maxt = torch.where(active, maxt, -1.0)
            depth = torch.where(regen, 0, depth + 1).to(torch.int32)
            beta = torch.where(regen[:, None], 1.0, beta)
            L = torch.where(regen[:, None], 0.0, L)
            spec = torch.where(regen, True, s.measure == E_DISCRETE)
            prev_pdf = torch.where(regen, 0.0, s.pdf)

            st = dict(q=q, q0=q0, active=active, depth=depth, o=o, d=d,
                      mint=mint, maxt=maxt, beta=beta, L=L, spec=spec,
                      prev_pdf=prev_pdf)

        # ---- coherence sort + record window -------------------------
        # Survivors are grouped by their candidate triangle tiles so
        # each 256-lane ray tile's candidate union stays small; freshly
        # terminated lanes sort last, so the flipped record columns put
        # the n_flush real records first in the window.
        with spans.span("step.sort"):
            tb = sd.tri_tile_bounds
            if sort_rays and n_tt <= 28:
                # exact candidate bitmask in one int key
                # (wavefront.py:449)
                inv_d = 1.0 / torch.where(
                    torch.abs(d) < 1e-20,
                    torch.where(d < 0, -1e-20, 1e-20), d)
                t0b = (tb[None, :, 0:3] - o[:, None]) * inv_d[:, None]
                t1b = (tb[None, :, 3:6] - o[:, None]) * inv_d[:, None]
                tnb = torch.amax(torch.minimum(t0b, t1b), dim=-1)
                tfb = torch.amin(torch.maximum(t0b, t1b), dim=-1)
                cand = ((tnb <= tfb) & (tfb >= mint[:, None])
                        & (tnb <= maxt[:, None]))
                bits = torch.bitwise_left_shift(
                    torch.ones(n_tt, dtype=torch.int64, device=device),
                    n_tt - 1 - torch.arange(n_tt, device=device))
                skey = torch.sum(torch.where(cand, bits[None, :], 0),
                                 dim=1)
                key = torch.where(done, KEY_DONE,
                                  torch.where(active, skey, KEY_IDLE))
            elif sort_rays:
                # (first tile | fine mask, coarse mask) from kernel K3,
                # sorted lexicographically as one int64 (wavefront.py:471)
                rays_pn, _ = pack_rays(o, d, mint, maxt)
                if not key_bounds:
                    key_bounds.append(_coarsen_bounds(tb, kc) if kc > 1
                                      and n_tt >= 2 * kc else tb)
                sk1, sk2 = lane_keys(key_bounds[0], rays_pn)
                sk1 = sk1[:N].to(torch.int64)
                sk2 = sk2[:N].to(torch.int64)
                k1 = torch.where(done, KEY_DONE,
                                 torch.where(active, sk1, KEY_IDLE))
                key = (k1 << 32) | sk2
            else:
                key = torch.where(done, KEY_DONE,
                                  torch.where(active, 0, KEY_IDLE))
            perm = torch.argsort(key, stable=True)
            m = _pack_state(st, rec_q, rec_l)[perm]
            st = _unpack_state(m, q0)
        if merged:
            with spans.span("step.mixed"):
                # one mixed launch: closest hits of the sorted next rays
                # and any hits of this step's shadow rays (in lane order
                # before the sort)
                pend, sh_args = deferred
                t_c, i_c, occ = intersect_mixed(
                    sd, st["o"], st["d"], st["mint"], st["maxt"], *sh_args,
                    raw=True)
                st["hit_t"], st["hit_tri"] = t_c[:N], i_c[:N]
                st["primed"] = True
                # the pending NEE contribution goes to L of surviving
                # lanes and to the record rows of lanes that ended this
                # step (their L was captured before the sweep)
                dlp = (pend * (~occ)[:, None])[perm]
                done_p = done[perm][:, None]
                st["L"] = st["L"] + torch.where(done_p, 0.0, dlp)
                rec_lp = m[:, 20:23] + torch.where(done_p, dlp, 0.0)
                window = torch.flip(
                    torch.cat([m[:, 19:20], rec_lp], dim=1), dims=[0])
        with spans.span("step.record"):
            if not merged:
                window = torch.flip(m[:, 19:23], dims=[0])
            records.index_copy_(0, w_cur + lane_iota, window)
            w_cur = w_cur + n_flush
        return (st, next_q, records, w_cur, rays, q_hi)

    def n_active(carry):
        return carry[0]["active"].sum()

    def finalize(records, q0: int):
        """Record log -> L_out (chunk, 3) in work-item order: every q in
        [q0, q_hi) terminated exactly once, so sorting by q - q0 gives
        slot order; sentinel rows (zero radiance) wrap to a huge value
        and sort last."""
        qs = (_f32_to_u32(records[:chunk, 0]) - q0) & _M32
        ordr = torch.argsort(qs, stable=True)
        return records[:chunk, 1:4][ordr]

    step = _GraphedStep(eager_step, device) if graph else eager_step
    return init, step, n_active, finalize


def make_shrink(n_from: int, n_to: int):
    """Pack the <= n_to active lanes of an n_from-wide carry into an
    n_to-wide carry (same chunk buffers)."""

    def shrink(carry):
        st, next_q, records, w_cur, rays, q_hi = carry
        active = st["active"]
        src = torch.zeros((n_to,), dtype=torch.int64, device=active.device)
        with spans.sync("shrink"):
            idx = torch.nonzero(active).squeeze(1)[:n_to]
        src[:idx.shape[0]] = idx
        small_active = torch.arange(n_to, device=active.device) < idx.shape[0]
        new_st = {k: (v if not torch.is_tensor(v) or v.dim() == 0
                      else v[src]) for k, v in st.items()}
        new_st["active"] = small_active
        # inactive packed lanes keep empty ray intervals
        new_st["mint"] = torch.where(small_active, new_st["mint"], 1.0)
        new_st["maxt"] = torch.where(small_active, new_st["maxt"], -1.0)
        return (new_st, next_q, records, w_cur, rays, q_hi)

    return shrink


def run_chunk(steppers, sd, seed, q0: int, q_end: int,
              check_every: int = CHECK_EVERY, count=_PendingCount,
              max_steps: int = 100000):
    """Drive one chunk to completion; returns (L_out, rays tensor,
    (steps, wide steps, lane steps)).  Both tensors are the chunk's own:
    a graphed stage's static carry is overwritten by the next chunk.

    steppers = (init, stages, finalize); stages lists (step, n_active,
    shrink_to_next) from widest to narrowest.  The host reads the
    occupancy every `check_every` steps and acts on the count of the
    window before: n_active == 0 is absorbing, and counts only decay
    during the drain, so a stale count is safe.  count(n_active tensor)
    is the handle whose value() the host reads a window later
    (a group's takes the largest count over the ranks, so every rank
    takes the same decisions).  Raises after max_steps steps.
    """
    init, stages, finalize = steppers
    with spans.span("chunk"):
        carry = init(seed, q0, q_end)
        it = wide_it = lane_steps = stage = 0
        pending = None
        while it < max_steps:
            step, n_act, _ = stages[stage]
            for _ in range(check_every):
                with spans.span("step"):
                    carry = step(sd, carry, seed)
                spans.count("steps")
                it += 1
                if stage == 0:
                    wide_it += 1
            lane_steps += check_every * carry[0]["active"].shape[0]
            handle = count(n_act(carry))
            if pending is not None:
                with spans.sync("pending"):
                    n = pending.value()
                if n == 0:
                    break
                # cascade through every stage the stale count qualifies
                # for
                while stages[stage][2] is not None and n <= (
                        carry[0]["active"].shape[0] // SHRINK_FACTOR):
                    with spans.span("shrink"):
                        carry = stages[stage][2](carry)
                    stage += 1
            pending = handle
        else:
            raise RuntimeError("run_chunk did not drain")
        with spans.span("finalize"):
            L_out = finalize(carry[2], q0)
    return L_out, carry[4].clone(), (it, wide_it, lane_steps)


def make_dense_splat(scene, chunk: int, device=None):
    """Scatter-free film splat for pixel-major work chunks, on `device`
    (default: the first CUDA device; device.resolve_device).

    Work items are ordered q = pixel * spp + sample, so a chunk covers a
    contiguous range of pixels.  For each of the D*D filter offsets the
    weighted contributions reduce over the spp axis and add into a
    contiguous slice of the flat film.  The weight window matches
    ImageBlock::put (src/block.cpp:81-103): the tap at pixel px+delta
    has filter argument delta - jitter + 0.5, windowed at radius r.

    Returns (new_film, splat_chunk, finalize); splat_chunk(film, L_out,
    seed, q0, q_end) adds into the film in place, q0 being the chunk's
    first work item as a 0-d int64 tensor on the device, which the host
    does not read (the graphed batch driver advances it on the device).
    Each tap adds its row sums with index_add_ at the chunk's pixels,
    which are distinct rows, so each film element gets one add a tap,
    in tap order, as a slice add would give.  The chunk's pixels past
    the image hold work items past the last, of weight 0 (a ragged last
    chunk, or a rank's share of the last global chunk that starts past
    the film, parallel.py): they fold onto the first pixel past the
    image, so that every tap's rows lie in the film, and add zeros
    there.  (The JAX package's dynamic_slice clamps such a slice's start
    instead, which moves the chunk's samples once the overrun exceeds
    the margin.)
    """
    device = resolve_device(device)
    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    rfilter = cam.rfilter
    r = float(rfilter.radius)
    d_lo = math.ceil(-0.5 - r)
    d_hi = math.floor(0.5 + r)
    deltas = list(range(d_lo, d_hi + 1))
    margin = (abs(d_lo) + 1) * w + abs(d_lo) + d_hi + 1
    npix = chunk // spp
    if chunk % spp:
        raise ValueError("chunk must be a multiple of spp")

    def new_film():
        return torch.zeros((w * h + 2 * margin, 4), dtype=torch.float32,
                           device=device)

    def splat_chunk(film, L_out, seed, q0, q_end: int):
        q = q0 + torch.arange(chunk, dtype=torch.int64, device=device)
        in_range = q < q_end
        jitter = rng.uniform2(seed, q, JITTER_STREAM)
        jx, jy = jitter[:, 0], jitter[:, 1]
        rgba = torch.cat([L_out, in_range.to(torch.float32)[:, None]], dim=-1)
        x = (q // spp) % w
        pix = torch.clamp_max(q0 // spp + torch.arange(
            npix, dtype=torch.int64, device=device), w * h)
        wx, wy = [], []
        for dv in deltas:
            ax = dv - jx + 0.5
            ay = dv - jy + 0.5
            wx.append(torch.where(torch.abs(ax) <= r, rfilter.eval(ax), 0.0))
            wy.append(torch.where(torch.abs(ay) <= r, rfilter.eval(ay), 0.0))
        for iy, dy in enumerate(deltas):
            for ix, dx in enumerate(deltas):
                wgt = wx[ix] * wy[iy]
                okx = (x + dx >= 0) & (x + dx < w)
                wgt = torch.where(okx & in_range, wgt, 0.0)
                contrib = (rgba * wgt[:, None]).reshape(npix, spp, 4)
                film[dy * w + dx + margin:].index_add_(
                    0, pix, torch.sum(contrib, dim=1))
        return film

    def finalize(film):
        inner = film[margin:margin + w * h].reshape(h, w, 4)
        wgt = inner[..., 3:4]
        return torch.where(wgt > 0.0,
                           inner[..., :3] / torch.clamp_min(wgt, 1e-20), 0.0)

    return new_film, splat_chunk, finalize


def _checkpoint_key(scene, spp: int, seed: int, chunk: int) -> str:
    """SHA-256 hex digest of everything that decides a render's sample
    values: geometry, materials and emitters, the camera projection, the
    reconstruction filter, the integrator and the sampling settings.  A
    checkpoint resumes only under an equal key.  The bytes hashed are the
    JAX package's (wavefront.py:713-735), so the two digests are equal:
    host arrays of compile_arrays() and of the camera's parameters."""
    arrays = scene.compile_arrays()
    h = hashlib.sha256()
    h.update(np.asarray(arrays["tri_v0"]).tobytes())
    h.update(np.asarray(arrays["mesh_attr"]).tobytes())  # BSDFs + radiance
    h.update(np.asarray(arrays["em_attr"]).tobytes())
    cp = scene.camera.ray_params("cpu")
    h.update(cp["camera_to_world"].numpy().tobytes())
    h.update(cp["sample_to_camera"].numpy().tobytes())
    h.update(scene.integrator.plugin_name.encode())
    h.update(np.float32(getattr(scene.camera.rfilter, "radius", 0.0))
             .tobytes())
    w, hh = scene.camera.output_size
    max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)
    h.update(np.asarray([w, hh, spp, seed, chunk, max_depth],
                        np.int64).tobytes())
    return h.hexdigest()


def _read_checkpoint(path: str, key: str, verbose: bool):
    """(film numpy array, next work item, rays so far) of the checkpoint
    at `path` if it is readable and its key is `key`, else None."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as d:
            if str(d["key"]) != key:
                if verbose:
                    print("  checkpoint config mismatch; starting fresh")
                return None
            return d["film"], int(d["next_q0"]), int(d["rays"])
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        if verbose:
            print(f"  unreadable checkpoint ({e}); starting fresh")
        return None


def _write_checkpoint(path: str, key: str, film, next_q0: int, rays: int):
    """Dump the film accumulator, the next chunk's first work item and
    the rays so far; written to a temporary file, then renamed over
    `path`, so a cut never leaves half a checkpoint."""
    tmp = path + ".tmp.npz"
    with spans.sync("copy_out"):
        film = film.cpu().numpy()
    np.savez(tmp, key=key, film=film, next_q0=next_q0, rays=rays)
    os.replace(tmp, path)


def wavefront_stages(scene, mode: int, n_lanes: int, chunk: int,
                     max_depth: int, sort_rays, device, merged: bool,
                     max_stages: int = MAX_SHRINK_STAGES):
    """run_chunk's steppers: (init, stages, finalize) at n_lanes lanes,
    and a drain-shrink cascade of at most max_stages successively
    SHRINK_FACTOR-x narrower pools (floored at 1024 lanes).  One merged
    decision serves every stage: a shrunk carry inherits its state."""

    def stepper(n):
        return make_wavefront_stepper(scene, mode, n, chunk, max_depth,
                                      sort_rays, device, merged)

    with spans.span("build"):
        init, step, n_act, finalize = stepper(n_lanes)
        stages = []
        n_cur = n_lanes
        for _ in range(max_stages):
            n_next = max(1024, n_cur // SHRINK_FACTOR)
            if n_next >= n_cur:
                break
            stages.append((step, n_act, make_shrink(n_cur, n_next)))
            _, step, n_act, _ = stepper(n_next)
            n_cur = n_next
        stages.append((step, n_act, None))
    return init, stages, finalize


def render_chunks(scene, sd, spp: int, seed: int, steppers, chunk: int,
                  device, coll=Solo, check_every: int = CHECK_EVERY,
                  max_steps: int = 100000, checkpoint_path: str | None = None,
                  key_suffix: str = "", max_chunks: int | None = None,
                  preview_path: str | None = None, on_chunk=None,
                  verbose: bool = False):
    """The chunk loop of render_wavefront and
    parallel.render_sharded_wavefront over coll's ranks (render.Solo:
    one device, no group).

    Work item space is cut into global chunks of coll.size * chunk
    items; rank r drives [q0 + r * chunk, q0 + (r + 1) * chunk) of each
    through run_chunk with steppers, the ranks in lockstep through
    coll.count.  Rank 0 gathers the ranks' radiance and splats it in q
    order, each rank's part as one chunk, so the film is render_wavefront
    (chunk=chunk)'s at any rank count.  Rank 0 alone reads and writes the
    checkpoint (key: _checkpoint_key plus key_suffix) and calls
    preview_path and on_chunk.  Returns ((H, W, 3) numpy image, stats),
    the same image on every rank.
    """
    w, h = scene.camera.output_size
    total_q = w * h * spp
    root = coll.rank == 0
    with spans.span("build"):
        new_film, splat_chunk, finalize_film = make_dense_splat(
            scene, chunk, device)
    film = new_film() if root else None
    global_chunk = coll.size * chunk
    n_chunks = (total_q + global_chunk - 1) // global_chunk

    resume = torch.zeros(2, dtype=torch.int64)
    ck_key = None
    if checkpoint_path:
        ck_key = _checkpoint_key(scene, spp, seed, chunk) + key_suffix
        saved = (_read_checkpoint(checkpoint_path, ck_key, verbose)
                 if root else None)
        if saved is not None:
            film = torch.from_numpy(saved[0]).to(device)
            resume = torch.tensor(saved[1:], dtype=torch.int64)
            if verbose:
                print(f"  resuming at chunk {saved[1] // global_chunk + 1}"
                      f"/{n_chunks}")
    q_start, rays_resumed = coll.broadcast(resume).tolist()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    ray_counts = []  # (coll.size,) per global chunk
    steps_total = wide_total = lane_steps_total = chunks_done = 0
    done = q_start >= total_q
    for q0 in range(q_start, total_q, global_chunk):
        L_out, rays, (its, wide, lsteps) = run_chunk(
            steppers, sd, seed, q0 + coll.rank * chunk, total_q,
            check_every, coll.count, max_steps)
        steps_total += its
        wide_total += wide
        lane_steps_total += lsteps
        with spans.span("gather"):
            ray_counts.append(coll.gather_ints(rays))
            parts = coll.gather(L_out)
        chunks_done += 1
        done = q0 + global_chunk >= total_q
        if root:
            # left-associative fold in q order; a rank's part that
            # starts past the last work item adds nothing
            with spans.span("splat"):
                for r, part in enumerate(parts):
                    if q0 + r * chunk < total_q:
                        film = splat_chunk(film, part, seed, torch.full(
                            (), q0 + r * chunk, dtype=torch.int64,
                            device=device), total_q)
            if checkpoint_path:
                with spans.sync("rays"):
                    rays_so_far = int(torch.stack(ray_counts).sum())
                _write_checkpoint(checkpoint_path, ck_key, film,
                                  q0 + global_chunk,
                                  rays_resumed + rays_so_far)
            if preview_path:
                # the film so far, in place of the reference's live
                # screen (src/gui.cpp:19-132)
                with spans.sync("copy_out"):
                    so_far = finalize_film(film).cpu().numpy()
                write_png(preview_path, so_far)
            if on_chunk is not None:
                with spans.sync("copy_out"):
                    so_far = finalize_film(film).cpu().numpy()
                on_chunk(so_far, (q0 + global_chunk) / max(total_q, 1))
            if verbose:
                print(f"  chunk {q0 // global_chunk + 1}/{n_chunks} "
                      f"({time.time() - t0:.2f}s)")
        if max_chunks is not None and chunks_done >= max_chunks:
            break
    if done and checkpoint_path and root and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)  # complete: nothing to resume
    img = finalize_film(film) if root else torch.empty(
        (h, w, 3), dtype=torch.float32, device=device)
    with spans.sync("copy_out"):
        img = coll.broadcast(img).cpu().numpy()
        count_gate_tally(device)
    dt = time.time() - t0
    with spans.sync("rays"):
        rays_per_dev = (torch.stack(ray_counts).sum(0).tolist()
                        if ray_counts else [0] * coll.size)
    total_rays = rays_resumed + sum(rays_per_dev)
    return img, {
        "spp": spp, "seconds": dt, "pixels": w * h, "rays": total_rays,
        "mrays_per_sec": total_rays / max(dt, 1e-9) / 1e6,
        "samples_per_sec": total_q / max(dt, 1e-9),
        "steps": steps_total,
        "wide_steps": wide_total,
        # fraction of sweep lanes that carried a live ray (each step
        # sweeps <= 2 rays per lane: closest hit + shadow); the ranks
        # step in lockstep, so each took this rank's lane steps
        "occupancy": total_rays / max(2 * coll.size * lane_steps_total, 1),
        "devices": coll.size,
        # balanced static q partitions agree within the scene's
        # per-pixel bounce variance; a skewed row means a partition fault
        "rays_per_dev": rays_per_dev,
        "done": done,
    }


def render_wavefront(scene, spp: int | None = None, seed: int = 0,
                     n_lanes: int = 131072, chunk: int | None = None,
                     verbose: bool = False, sort_rays: bool | None = None,
                     device=None, merged: bool | None = None,
                     preview_path: str | None = None,
                     checkpoint_path: str | None = None,
                     max_chunks: int | None = None,
                     on_chunk=None, check_every: int = CHECK_EVERY):
    """Render a path-family scene with the persistent wavefront on
    `device` (default: the first CUDA device; device.resolve_device).
    merged: take the merged step (None reads config.MERGED_SWEEP; NEE
    modes on resident scenes only).

    checkpoint_path: after every chunk, dump the film accumulator, the
    next chunk's cursor and the ray count there; a render cut short and
    run again with the same arguments resumes after its last finished
    chunk and gives the same image bit for bit (each chunk's samples
    depend on their work-item ids alone; the image equals an uncut
    render's with the same `chunk`, since the chunks' splats add into
    the film in turn).  The file is removed when the render completes.
    max_chunks: render at most this many chunks in this call.
    preview_path: write the film so far as a PNG after every chunk.
    on_chunk(image, fraction): called after every chunk with the film so
    far and the fraction of work items done (the tui live view).  Each
    of the three copies the film to the host once per chunk.
    check_every: steps between the host's occupancy reads (run_chunk);
    it changes no sample value.

    Returns ((H, W, 3) numpy image, stats); stats["done"] says whether
    every chunk has been rendered (with max_chunks, the image is the
    accumulation so far).  The render's CUDA graphs are released when it
    returns.
    """
    device = resolve_device(device)
    with spans.span("image"):
        sd, spp = prepare(scene, spp, device)
        w, h = scene.camera.output_size
        mode = getattr(scene.integrator, "mode", MIS)
        max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)
        merged = merged_step(scene, mode, merged)

        total_q = w * h * spp
        n_lanes = min(n_lanes, max(4096, total_q))
        if chunk is None:
            # the record log costs 16 B per work item: 2^25 items = 512 MB
            chunk = min(total_q, max(64 * n_lanes, 1 << 25))
        chunk = max(spp, (chunk // spp) * spp)
        steppers = wavefront_stages(scene, mode, n_lanes, chunk, max_depth,
                                    sort_rays, device, merged)
        try:
            img, stats = render_chunks(
                scene, sd, spp, seed, steppers, chunk, device,
                check_every=check_every, checkpoint_path=checkpoint_path,
                max_chunks=max_chunks, preview_path=preview_path,
                on_chunk=on_chunk, verbose=verbose)
        finally:
            release_graphs(steppers)
    stats.update(merged=merged, device=str(device))
    return img, stats
