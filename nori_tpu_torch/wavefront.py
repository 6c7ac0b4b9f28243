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

Determinism: lanes key the counter-based RNG by global sample id q, so
a sample's value does not depend on lane order or pool width.

Work item ids are uint32 in the JAX package; here they are int64
tensors holding uint32 values, masked where a uint32 would wrap.  The
state carried between steps is a dict of tensors; `step` returns a new
one and writes the chunk's record log in place (the JAX package
donates it).  Nothing in a step reads a device value on the host.
"""

from __future__ import annotations

import math
import time

import torch

from nori_tpu_torch.accel.sweep import lane_keys, pack_rays
from nori_tpu_torch.bsdf import E_DISCRETE
from nori_tpu_torch.core import rng
from nori_tpu_torch.core.vecmath import EPSILON, to_world
from nori_tpu_torch.integrators.path import MIS, path_vertex
from nori_tpu_torch.render import JITTER_STREAM

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
    n_rows rows and whose tile bounds n_tt boxes: the JAX package's
    factors (auto_key_coarsen, wavefront.py:119-130), 8 for streamed
    scenes (16-row operands), 4 above 256 tiles, else 1.  Kept for key
    parity; parameters to re-measure on the H100, not Hopper
    measurements."""
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


def make_wavefront_stepper(scene, mode: int, n_lanes: int, chunk: int,
                           max_depth: int = MAX_DEPTH,
                           sort_rays: bool | None = None,
                           device="cpu"):
    """Build (init, step, n_active, finalize) for one pool width.

    carry = (state dict, next_q, records (chunk + N, 4), w_cursor,
    rays, q_hi), the scalars 0-d int64 tensors on `device`; work items
    q in [q0, q_hi).  records rows are [q-bits, L.rgb]; rows past the
    cursor are garbage that later windows overwrite.
    """
    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params(device)
    N = n_lanes
    arrays = scene.compile_arrays()
    n_tt = int(arrays["tri_tile_bounds"].shape[0])
    kc = key_coarsen(arrays["tri_packed"].shape[0], n_tt)
    if sort_rays is None:
        # coherence sorting pays only when the sweep has enough
        # triangle tiles to prune
        sort_rays = n_tt >= 16
    lane_iota = torch.arange(N, dtype=torch.int64, device=device)

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
        # q column = sentinel bits (int32 -1 == uint32 0xFFFFFFFF)
        records = torch.zeros((chunk + N, 4), dtype=torch.int32,
                              device=device)
        records[:, 0] = -1
        records = records.view(torch.float32)
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return (state, torch.tensor(q0 + N, device=device), records,
                zero.clone(), zero.clone(), q_hi)

    def step(sd, carry, seed):
        st, next_q, records, w_cur, rays, q_hi = carry
        q, active, depth = st["q"], st["active"], st["depth"]
        q0 = st["q0"]
        o, d, mint, maxt = st["o"], st["d"], st["mint"], st["maxt"]
        beta, L = st["beta"], st["L"]
        spec, prev_pdf = st["spec"], st["prev_pdf"]

        rays = rays + active.sum()
        its, frame, s, L, beta, alive, n_shadow = path_vertex(
            sd, mode, o, d, mint, maxt, active, depth, beta, L, spec,
            prev_pdf, seed, q)
        rays = rays + n_shadow
        alive = alive & (depth + 1 < max_depth)

        # ---- terminate ----------------------------------------------
        done = active & ~alive
        # record columns captured BEFORE regeneration overwrites q/L;
        # other rows get the sentinel so garbage window rows never
        # collide with a real sample slot
        rec_q = torch.where(done, q, REC_SENTINEL)
        rec_l = torch.where(done[:, None], L, 0.0)
        n_flush = done.sum()

        # ---- regenerate ---------------------------------------------
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
        tb = sd.tri_tile_bounds
        if sort_rays and n_tt <= 28:
            # exact candidate bitmask in one int key (wavefront.py:449)
            inv_d = 1.0 / torch.where(
                torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
            t0b = (tb[None, :, 0:3] - o[:, None]) * inv_d[:, None]
            t1b = (tb[None, :, 3:6] - o[:, None]) * inv_d[:, None]
            tnb = torch.amax(torch.minimum(t0b, t1b), dim=-1)
            tfb = torch.amin(torch.maximum(t0b, t1b), dim=-1)
            cand = ((tnb <= tfb) & (tfb >= mint[:, None])
                    & (tnb <= maxt[:, None]))
            bits = torch.bitwise_left_shift(
                torch.ones(n_tt, dtype=torch.int64, device=device),
                n_tt - 1 - torch.arange(n_tt, device=device))
            skey = torch.sum(torch.where(cand, bits[None, :], 0), dim=1)
            key = torch.where(done, KEY_DONE,
                              torch.where(active, skey, KEY_IDLE))
        elif sort_rays:
            # (first tile | fine mask, coarse mask) from kernel K3,
            # sorted lexicographically as one int64 (wavefront.py:471)
            rays_pn, _ = pack_rays(o, d, mint, maxt)
            kb = tb
            if kc > 1 and n_tt >= 2 * kc:
                kb = _coarsen_bounds(tb, kc)
            sk1, sk2 = lane_keys(kb, rays_pn)
            sk1, sk2 = sk1[:N].to(torch.int64), sk2[:N].to(torch.int64)
            k1 = torch.where(done, KEY_DONE, torch.where(active, sk1,
                                                         KEY_IDLE))
            key = (k1 << 32) | sk2
        else:
            key = torch.where(done, KEY_DONE,
                              torch.where(active, 0, KEY_IDLE))
        perm = torch.argsort(key, stable=True)
        m = _pack_state(st, rec_q, rec_l)[perm]
        st = _unpack_state(m, q0)
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

    return init, step, n_active, finalize


def make_shrink(n_from: int, n_to: int):
    """Pack the <= n_to active lanes of an n_from-wide carry into an
    n_to-wide carry (same chunk buffers)."""

    def shrink(carry):
        st, next_q, records, w_cur, rays, q_hi = carry
        active = st["active"]
        src = torch.zeros((n_to,), dtype=torch.int64, device=active.device)
        idx = torch.nonzero(active).squeeze(1)[:n_to]
        src[:idx.shape[0]] = idx
        small_active = torch.arange(n_to, device=active.device) < idx.shape[0]
        new_st = {k: (v if v.dim() == 0 else v[src]) for k, v in st.items()}
        new_st["active"] = small_active
        # inactive packed lanes keep empty ray intervals
        new_st["mint"] = torch.where(small_active, new_st["mint"], 1.0)
        new_st["maxt"] = torch.where(small_active, new_st["maxt"], -1.0)
        return (new_st, next_q, records, w_cur, rays, q_hi)

    return shrink


class _PendingCount:
    """A device count read on the host one window late: on a CUDA
    device the copy is asynchronous and waits only for the work queued
    before it, not for the steps enqueued since."""

    def __init__(self, count: torch.Tensor):
        if count.is_cuda:
            self._host = count.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = count, None

    def value(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


def run_chunk(steppers, sd, seed, q0: int, q_end: int):
    """Drive one chunk to completion; returns (L_out, rays tensor,
    (steps, wide steps, lane steps)).

    steppers = (init, stages, finalize); stages lists (step, n_active,
    shrink_to_next) from widest to narrowest.  The occupancy check the
    host acts on is one window old; n_active == 0 is absorbing, and
    counts only decay during the drain, so a stale count is safe.
    """
    init, stages, finalize = steppers
    carry = init(seed, q0, q_end)
    it = wide_it = lane_steps = stage = 0
    pending = None
    while it < 100000:
        step, n_act, _ = stages[stage]
        for _ in range(CHECK_EVERY):
            carry = step(sd, carry, seed)
            it += 1
            if stage == 0:
                wide_it += 1
        lane_steps += CHECK_EVERY * carry[0]["active"].shape[0]
        handle = _PendingCount(n_act(carry))
        if pending is not None:
            n = pending.value()
            if n == 0:
                break
            # cascade through every stage the stale count qualifies for
            while stages[stage][2] is not None and n <= (
                    carry[0]["active"].shape[0] // SHRINK_FACTOR):
                carry = stages[stage][2](carry)
                stage += 1
        pending = handle
    else:
        raise RuntimeError("run_chunk did not drain")
    L_out = finalize(carry[2], q0)
    return L_out, carry[4], (it, wide_it, lane_steps)


def make_dense_splat(scene, chunk: int, device="cpu"):
    """Scatter-free film splat for pixel-major work chunks.

    Work items are ordered q = pixel * spp + sample, so a chunk covers a
    contiguous range of pixels.  For each of the D*D filter offsets the
    weighted contributions reduce over the spp axis and add into a
    contiguous slice of the flat film.  The weight window matches
    ImageBlock::put (src/block.cpp:81-103): the tap at pixel px+delta
    has filter argument delta - jitter + 0.5, windowed at radius r.

    Returns (new_film, splat_chunk, finalize); splat_chunk adds into the
    film in place.
    """
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

    def splat_chunk(film, L_out, seed, q0: int, q_end: int):
        q = q0 + torch.arange(chunk, dtype=torch.int64, device=device)
        in_range = q < q_end
        jitter = rng.uniform2(seed, q, JITTER_STREAM)
        jx, jy = jitter[:, 0], jitter[:, 1]
        rgba = torch.cat([L_out, in_range.to(torch.float32)[:, None]], dim=-1)
        x = (q // spp) % w
        p0 = q0 // spp
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
                start = p0 + dy * w + dx + margin
                film[start:start + npix] += torch.sum(contrib, dim=1)
        return film

    def finalize(film):
        inner = film[margin:margin + w * h].reshape(h, w, 4)
        wgt = inner[..., 3:4]
        return torch.where(wgt > 0.0,
                           inner[..., :3] / torch.clamp_min(wgt, 1e-20), 0.0)

    return new_film, splat_chunk, finalize


def render_wavefront(scene, spp: int | None = None, seed: int = 0,
                     n_lanes: int = 131072, chunk: int | None = None,
                     verbose: bool = False, sort_rays: bool | None = None,
                     device=None):
    """Render a path-family scene with the persistent wavefront on
    `device` (default: the first CUDA device if there is one).

    Returns ((H, W, 3) numpy image, stats).  Checkpoint/resume, preview
    snapshots and the per-chunk callback of the JAX package are not
    ported yet (ROADMAP.md).
    """
    device = torch.device(
        device or ("cuda" if torch.cuda.is_available() else "cpu"))
    sd = scene.compile(device)
    cam = scene.camera
    w, h = cam.output_size
    if spp is not None:
        scene.sampler.sample_count = spp
    spp = scene.sampler.sample_count
    scene.integrator.preprocess(scene)
    mode = getattr(scene.integrator, "mode", MIS)
    max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)

    total_q = w * h * spp
    n_lanes = min(n_lanes, max(4096, total_q))
    if chunk is None:
        # the record log costs 16 B per work item: 2^25 items = 512 MB
        chunk = min(total_q, max(64 * n_lanes, 1 << 25))
    chunk = max(spp, (chunk // spp) * spp)

    def stepper(n):
        return make_wavefront_stepper(scene, mode, n, chunk, max_depth,
                                      sort_rays, device)

    init, step, n_act, finalize = stepper(n_lanes)
    # drain-shrink cascade: successively SHRINK_FACTOR-x narrower pools
    # (floored at 1024 lanes, at most MAX_SHRINK_STAGES of them)
    stages = []
    n_cur = n_lanes
    for _ in range(MAX_SHRINK_STAGES):
        n_next = max(1024, n_cur // SHRINK_FACTOR)
        if n_next >= n_cur:
            break
        stages.append((step, n_act, make_shrink(n_cur, n_next)))
        _, step, n_act, _ = stepper(n_next)
        n_cur = n_next
    stages.append((step, n_act, None))
    steppers = (init, stages, finalize)
    new_film, splat_chunk, finalize_film = make_dense_splat(
        scene, chunk, device)
    film = new_film()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    ray_counts = []
    steps_total = wide_total = lane_steps_total = 0
    for q0 in range(0, total_q, chunk):
        L_out, rays, (its, wide, lsteps) = run_chunk(
            steppers, sd, seed, q0, total_q)
        steps_total += its
        wide_total += wide
        lane_steps_total += lsteps
        film = splat_chunk(film, L_out, seed, q0, total_q)
        ray_counts.append(rays)
        if verbose:
            print(f"  chunk {q0 // chunk + 1}/"
                  f"{(total_q + chunk - 1) // chunk} "
                  f"({time.time() - t0:.2f}s)")
    img = finalize_film(film).cpu().numpy()
    dt = time.time() - t0
    total_rays = int(sum(int(r) for r in ray_counts))
    return img, {
        "spp": spp, "seconds": dt, "pixels": w * h, "rays": total_rays,
        "mrays_per_sec": total_rays / max(dt, 1e-9) / 1e6,
        "samples_per_sec": total_q / max(dt, 1e-9),
        "steps": steps_total,
        "wide_steps": wide_total,
        # fraction of sweep lanes that carried a live ray (each step
        # sweeps <= 2 rays per lane: closest hit + shadow)
        "occupancy": total_rays / max(2 * lane_steps_total, 1),
        "device": str(device),
    }
