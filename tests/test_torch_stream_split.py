"""The schedule of the streamed sweep (csrc/stream_sweep.cu, K5 and
K5-cull) and of the 2-D sweep (csrc/mt_sweep.cu, K6), emulated on the
CPU, against the dense plain versions, the one-pass walks they replace
and the JAX package's kernels in interpret mode.

The emulation runs the kernels' schedule step by step: a plan that cuts
each ray tile's keys (positions of its visit order, for K6) that pass
its first skyline into chunks of S, each chunk four work items, one per
quarter of the slabs or tiles; the items taken chunk-major or in a
shuffled order, each starting from the packed per-ray best, shut if its
first key lies beyond the ray tile's published skyline, walking its keys
with the skyline (K6: the reach) recomputed after every quarter, and
folding into the packed best by the packed-word minimum after every
quarter, where it also takes over a better word another item left there
(share_best); the last item of a ray tile writing its answers.  K5 tests
a quarter in sub-blocks of STREAM_G triangles, each only in the warps
(32 consecutive rays) one of whose searching rays enters the widened box
that covers it (common.cuh gate_box, emulated in float32 in the kernel's
order): the scene's boxes of G, or K5-cull's of 128 or 64.  The
shuffled runs keep several items in flight and advance a random one by
a quarter at a time, as blocks on the card interleave.

Tolerances: against the plain version (the same pair-test rounding),
exact: equal hit masks and, for closest hits, equal triangles and equal
t bits (K6: t bits, and triangles except at exact ties in t, where the
one-pass rule decides; u and v bit-equal to the in-walk ones).  Against
the JAX package, as tests/test_torch_stream.py: hit masks equal, t
within rtol 1e-6 (1e-5 on the synthetic soup and with sub-slab culling,
as the existing tests), triangles equal except where two candidates' t
tie within that tolerance.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu.accel import pallas_mt
from nori_tpu import scenes_builtin as jax_scenes

from nori_tpu_torch import scene as torch_scene
from nori_tpu_torch.accel import sweep

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISS = 0xFF800000FFFFFFFF
F32_INF = np.float32(np.inf)
N, U, Q = sweep.TILE_N, sweep.STREAM_U, sweep.STREAM_T // sweep.STREAM_U
G, NW = sweep.STREAM_G, sweep.TILE_N // 32


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ---------------------------------------------------------------------------
# the packed best (common.cuh pack_best / unpack_best)
# ---------------------------------------------------------------------------

def pack_best(t, i):
    """(t, idx) arrays -> uint64 words whose order is the fold's."""
    t = np.asarray(t, np.float32)
    i = np.asarray(i, np.int64)
    b = t.view(np.uint32).astype(np.uint64)
    hi = np.where(t == 0, 0x80000000,
                  np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000))
    lo = (i.astype(np.uint64) << np.uint64(1)) | (b >> np.uint64(31))
    return np.where(i < 0, np.uint64(MISS),
                    (hi.astype(np.uint64) << np.uint64(32)) | lo)


def unpack_best(p):
    p = np.asarray(p, np.uint64)
    hi = (p >> np.uint64(32)).astype(np.uint64)
    lo = (p & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    b = np.where(hi == 0x80000000, (lo & 1) << np.uint64(31),
                 np.where(hi & 0x80000000, hi & 0x7FFFFFFF,
                          ~hi & 0xFFFFFFFF))
    miss = lo == 0xFFFFFFFF
    t = np.where(miss, np.uint32(0x7F800000), b.astype(np.uint32))
    return (t.astype(np.uint32).view(np.float32),
            np.where(miss, -1, (lo >> np.uint64(1)).astype(np.int64)))


def _fold(bt, bi, search, hit, t, base, uv=None, buv=None):
    """The pair loop's fold of one quarter, (256, U) hit and t, into the
    rays still searching: the smallest t, then the lowest index."""
    tm = np.where(hit, t, F32_INF)
    c = tm.argmin(1)                       # the first of equal minima
    rows = np.arange(t.shape[0])
    tc, key = t[rows, c], base + c
    better = search & hit[rows, c] & ((tc < bt) | ((tc == bt) & (key < bi)))
    if uv is not None:
        for k in range(2):
            buv[k] = np.where(better, uv[k][rows, c], buv[k])
    return np.where(better, tc, bt), np.where(better, key, bi)


def _item_order(records, S, seed):
    """The kernel's item numbers, chunk-major over the records with the
    quarters innermost: [(ray tile, k0, k1, quarter)]; shuffled for a
    seed."""
    most = max((-(-(k_end - k) // S) for _, k, k_end in records), default=0)
    items = []
    for chunk in range(most):
        for rt, k, k_end in records:
            k0 = k + chunk * S
            if k0 < k_end:
                items += [(rt, k0, min(k0 + S, k_end), q) for q in range(Q)]
    if seed is not None:
        items = [items[i] for i in
                 np.random.default_rng(seed).permutation(len(items))]
    return items


def _share(best, known, bt, bi):
    """common.cuh share_best on a ray tile's slice of the packed bests:
    publish what is better than `known`, take over what is better than
    mine; returns (known, bt, bi)."""
    mine = pack_best(bt, bi)
    pub = mine < known
    best[pub] = np.minimum(best[pub], mine[pub])
    known = np.where(pub, mine, known)
    there = best.copy()
    take = there < mine
    tt, ti = unpack_best(there)
    return (np.where(take, there, known), np.where(take, tt, bt),
            np.where(take, ti, bi))


def _run_items(items, start, done, seed):
    """Take the items in order: one at a time without a seed, else up to
    six in flight, a random one advanced by a quarter at a time.
    start(item) gives the item's walk as a generator, or None for a shut
    item; done(item) takes its pending count."""
    rng = np.random.default_rng(seed)
    width = 1 if seed is None else 6
    queue, pool = list(items), []
    while queue or pool:
        while queue and len(pool) < width:
            item = queue.pop(0)
            gen = start(item)
            if gen is None:
                done(item)
            else:
                pool.append((item, gen))
        if not pool:
            continue
        at = int(rng.integers(len(pool)))
        try:
            next(pool[at][1])
        except StopIteration:
            done(pool.pop(at)[0])


# ---------------------------------------------------------------------------
# K5: the streamed sweep's schedule
# ---------------------------------------------------------------------------

def gate_box(box, rays, tu):
    """common.cuh gate_box of every ray of (8, n) rays against one box
    [lo xyz | hi xyz | pad], with useful t `tu`: the box widened by
    GATE_PAD times the largest coordinate magnitude of the box and the
    ray's origin, then the slab test on [mint, tu]; float32 throughout,
    in the kernel's order.  (n,) bool numpy."""
    box = torch.as_tensor(box)
    if not bool(box[0] <= box[3]):
        return np.zeros(rays.shape[1], bool)
    o = rays[0:3].T
    m = torch.maximum(o.abs().amax(1), box[0:6].abs().amax())
    e = (m * sweep.GATE_PAD)[:, None]
    cand, _ = sweep._slab(box[0:3] - e, box[3:6] + e, o,
                          sweep._safe_inv(rays[3:6].T), rays[6],
                          torch.as_tensor(tu))
    return cand.numpy()


class _StreamTile:
    """One ray tile's rays and the (16, T) operand; `gate` (sub_t,
    boxes) gates each sub-block of G triangles per warp by the boxes of
    sub_t triangles that cover it, None tests every sub-block in every
    warp with a ray that searches."""

    def __init__(self, op, use_bw, rays, ah, gate):
        self.rows = op[:12] if use_bw else op[:9]
        self.rays, self.ah = rays, ah
        r = rays.numpy()
        self.r = r
        self.live = r[6] <= r[7]
        self.maxt = r[7]
        self.gate = gate
        self.groups = set()   # first triangles of the sub-blocks tested

    def search(self, bi):
        return self.live & ~(bi >= 0) if self.ah else self.live

    def skyline(self, bt, bi):
        """(t_hi as int bits, alive), as the kernel's reduction."""
        need = self.search(bi)
        tc = np.where(need, np.fmin(bt, self.maxt), np.float32(0))
        tc = np.where(tc > 0, tc, np.float32(0)).astype(np.float32)
        t_hi = int(tc.view(np.int32).max())
        return t_hi, (bool(need.any()) if self.ah else t_hi > 0)

    def wanted(self, lo, bt, need):
        """The per-ray gate of the sub-block of G triangles from lo: a
        ray that searches and may hit a triangle of it within its useful
        t (maxt for any-hit, min(bt, maxt) for closest)."""
        if self.gate is None:
            return need
        sub_t, boxes = self.gate
        tu = self.maxt if self.ah else np.fmin(bt, self.maxt)
        want = np.zeros_like(need)
        for b in range(lo // sub_t, (lo + G - 1) // sub_t + 1):
            want |= gate_box(boxes[b], self.rays, tu)
        return want & need

    def quarter(self, j, q, bt, bi, count):
        """Test quarter q of slab j in sub-blocks of G, each in the warps
        whose gate lets it through; adds to count [warp sub-blocks
        tested, skipped while a ray of the warp searched]; returns (bt,
        bi)."""
        r = self.rays
        o = (r[0][:, None], r[1][:, None], r[2][:, None])
        d = (r[3][:, None], r[4][:, None], r[5][:, None])
        for c0 in range(0, U, G):
            lo = j * sweep.STREAM_T + q * U + c0
            need = self.search(bi)
            warp = self.wanted(lo, bt, need).reshape(-1, 32).any(1)
            count[0] += int(warp.sum())
            count[1] += int((~warp & need.reshape(-1, 32).any(1)).sum())
            if not warp.any():
                continue
            self.groups.add(lo)
            hit, t = sweep._pair_test(self.rows[:, lo:lo + G], o, d,
                                      r[6][:, None], r[7][:, None])
            bt, bi = _fold(bt, bi, need & np.repeat(warp, 32), hit.numpy(),
                           t.numpy(), lo)
        return bt, bi

    def walk(self, row, mask, k0, k1, q, best, trace, out):
        """stream_walk as a generator that yields after every quarter:
        quarter q of the slabs of keys row[k0:k1], from and into the ray
        tile's packed bests; leaves (t_hi, alive, [warp sub-blocks
        tested, culled]) in out."""
        known = best.copy()
        bt, bi = unpack_best(known)
        t_hi, alive = self.skyline(bt, bi)
        count, k = [0, 0], k0
        while alive and k < k1 and int(row[k] & ~mask) <= t_hi:
            j = int(row[k] & mask)
            trace.append((j, q))
            bt, bi = self.quarter(j, q, bt, bi, count)
            known, bt, bi = _share(best, known, bt, bi)
            t_hi, alive = self.skyline(bt, bi)
            k += 1
            yield
        best[:] = np.minimum(best, pack_best(bt, bi))
        out.update(t_hi=t_hi, alive=alive, tested=count[0],
                   culled=count[1])


def stream_split(op, use_bw, keys, idx_bits, rays, any_hit, S, seed=None,
                 gate=None):
    """The plan and the work items on (8, N) rays, gated by `gate`
    (sub_t, boxes) or not at all; returns (t, idx, warp sub-blocks
    tested per ray tile, items taken, shut items, walks: the (slab,
    quarter) visits of each item per ray tile, warp sub-blocks the
    gates skipped while a ray searched)."""
    keys = keys.numpy()
    n_rt = rays.shape[1] // N
    mask = (1 << idx_bits) - 1
    t_out = np.full(rays.shape[1], F32_INF)
    i_out = np.full(rays.shape[1], -1, np.int64)
    best = np.full(rays.shape[1], MISS, np.uint64)
    visits = np.zeros(n_rt, np.int64)
    tiles, records, pending, row_hi, walks = {}, [], {}, {}, {}
    for rt in range(n_rt):
        tile = _StreamTile(op, use_bw, rays[:, rt * N:(rt + 1) * N], any_hit,
                           gate)
        tiles[rt] = tile
        walks[rt] = []
        t_hi, alive = tile.skyline(np.full(N, F32_INF),
                                   np.full(N, -1, np.int64))
        k_end = int(((keys[rt] & ~mask) <= t_hi).sum()) if alive else 0
        if k_end:
            records.append((rt, 0, k_end))
            pending[rt] = -(-k_end // S) * Q
            row_hi[rt] = t_hi
    items = _item_order(records, S, seed)
    state = dict(shut=0, culled=0)

    def start(item):
        rt, k0, k1, q = item
        if int(keys[rt, k0] & ~mask) > row_hi[rt]:
            state["shut"] += 1
            return None
        walks[rt].append([])
        item_out[item] = {}
        return tiles[rt].walk(keys[rt], mask, k0, k1, q,
                              best[rt * N:(rt + 1) * N], walks[rt][-1],
                              item_out[item])

    def done(item):
        rt = item[0]
        out = item_out.pop(item, None)
        if out is not None:
            visits[rt] += out["tested"]
            state["culled"] += out["culled"]
            row_hi[rt] = min(row_hi[rt], out["t_hi"] if out["alive"] else -1)
        pending[rt] -= 1
        if pending[rt] == 0:
            sl = slice(rt * N, (rt + 1) * N)
            t_out[sl], i_out[sl] = unpack_best(best[sl])

    item_out = {}
    _run_items(items, start, done, seed)
    assert all(v == 0 for v in pending.values())
    groups = set().union(*(tile.groups for tile in tiles.values()))
    return (t_out, i_out, visits, items, state["shut"], walks,
            state["culled"], groups)


def one_pass_stream(op, use_bw, keys, idx_bits, rays, any_hit):
    """The walk the schedule replaces: one block per ray tile over whole
    slabs in key order, ungated; returns (t, idx, slabs visited per ray
    tile)."""
    keys = keys.numpy()
    mask = (1 << idx_bits) - 1
    n_rt = rays.shape[1] // N
    t_out = np.empty(rays.shape[1], np.float32)
    i_out = np.empty(rays.shape[1], np.int64)
    visits = np.zeros(n_rt, np.int64)
    for rt in range(n_rt):
        tile = _StreamTile(op, use_bw, rays[:, rt * N:(rt + 1) * N], any_hit,
                           None)
        bt, bi = np.full(N, F32_INF), np.full(N, -1, np.int64)
        t_hi, alive = tile.skyline(bt, bi)
        for k in range(keys.shape[1]):
            if not alive or int(keys[rt, k] & ~mask) > t_hi:
                break
            for q in range(Q):
                bt, bi = tile.quarter(int(keys[rt, k] & mask), q, bt, bi,
                                      [0, 0])
            visits[rt] += 1
            t_hi, alive = tile.skyline(bt, bi)
        t_out[rt * N:(rt + 1) * N], i_out[rt * N:(rt + 1) * N] = bt, bi
    return t_out, i_out, visits


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _pack(o, d, mint, maxt):
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))


@pytest.fixture(scope="module")
def slabbed():
    """Living room at detail 3 with STREAM_T slab bounds and 16-row
    operands (zero rows appended), as tests/test_torch_stream.py, and
    (8, 768) rays: camera rays, bounce-like rays with maxt 1e30, every
    17th lane idle."""
    js = jax_scenes.living_room(32, 32, 1, detail=3)
    jsd = js.compile()
    tb = np.asarray(jsd.tri_tile_bounds)
    grp = pallas_mt.STREAM_T // pallas_mt.FINE_T
    n_s = tb.shape[0] // grp
    cover = n_s * pallas_mt.STREAM_T
    tb_s = np.zeros((n_s, 8), np.float32)
    tb_s[:, 0:3] = tb[:n_s * grp, 0:3].reshape(n_s, grp, 3).min(1)
    tb_s[:, 3:6] = tb[:n_s * grp, 3:6].reshape(n_s, grp, 3).max(1)

    def pad16(op):
        op = np.asarray(op)[:, :cover]
        return np.concatenate(
            [op, np.zeros((16 - op.shape[0], cover), np.float32)])

    rng = np.random.RandomState(11)
    cam = js.camera
    pos = jnp.asarray((rng.rand(256, 2) * 32).astype(np.float32))
    o_c, d_c, mint_c, maxt_c = (
        np.asarray(a) for a in type(cam).sample_rays(cam.ray_params(), pos))
    center = np.asarray(jsd.scene_bounds)[0, 0:3]
    half = float(np.asarray(jsd.scene_bounds)[0, 3])
    o_b = (center + (rng.rand(512, 3) - 0.5) * half).astype(np.float32)
    d_b = rng.randn(512, 3).astype(np.float32)
    d_b /= np.linalg.norm(d_b, axis=1, keepdims=True)
    mint = np.concatenate([mint_c, np.full(512, 1e-4, np.float32)])
    maxt = np.concatenate([maxt_c, np.full(512, 1e30, np.float32)])
    mint[::17], maxt[::17] = 1.0, -1.0
    rays = _pack(np.concatenate([o_c, o_b]), np.concatenate([d_c, d_b]),
                 mint, maxt)
    return ({True: pad16(jsd.tri_bw), False: pad16(jsd.tri_packed)}, tb_s,
            rays, np.asarray(jsd.scene_bounds))


def _shadow_rays(op_mt, rays):
    """Shadow segments from the closest hits of `rays` towards random
    points around them (idle where there is no hit)."""
    t, i = (a.numpy() for a in sweep.stream_sweep_plain(
        _t(op_mt), _t(rays), False, False))
    rng = np.random.RandomState(3)
    p = rays[0:3].T + np.where(i >= 0, t, 0)[:, None] * rays[3:6].T
    w = rng.randn(*p.shape)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    maxt = np.where(i >= 0, rng.rand(p.shape[0]) * 4 + 0.5, -1.0)
    return _pack(p.astype(np.float32), w.astype(np.float32),
                 np.full(p.shape[0], 1e-4, np.float32),
                 maxt.astype(np.float32))


# the synthetic soup: 8 slabs of 512 small triangles in [0, 10]^3, the
# slabs in order of decreasing x, and one axis-aligned triangle in the
# plane x = 7 twice: index TIE_LO in slab 1 (entered late by +x rays)
# and TIE_HI in slab 6 (entered early), so the two copies fall into
# different work items
TIE_LO, TIE_HI = 512 + 130, 6 * 512 + 5
TIE_V0 = np.array([7.0, 5.0, 5.0], np.float32)
TIE_E1 = np.array([0.0, 0.5, 0.0], np.float32)
TIE_E2 = np.array([0.0, 0.0, 0.5], np.float32)
SOUP_SLABS = 8


@pytest.fixture(scope="module")
def soup():
    """(v0, e1, e2) numpy (T, 3), slab bounds (8, 8)."""
    rng = np.random.RandomState(5)
    T = SOUP_SLABS * sweep.STREAM_T
    c = rng.rand(T, 3) * 10
    c = c[np.argsort(-c[:, 0], kind="stable")]
    # keep the square the tie rays cross clear of other triangles
    clear = (np.abs(c[:, 1] - 5.25) < 0.75) & (np.abs(c[:, 2] - 5.25) < 0.75)
    c[clear, 2] -= 3.0
    v0 = (c + rng.randn(T, 3) * 0.02).astype(np.float32)
    e1 = (rng.randn(T, 3) * 0.08).astype(np.float32)
    e2 = (rng.randn(T, 3) * 0.08).astype(np.float32)
    for k in (TIE_LO, TIE_HI):
        v0[k], e1[k], e2[k] = TIE_V0, TIE_E1, TIE_E2
    p = np.stack([v0, v0 + e1, v0 + e2])                   # (3, T, 3)
    tb = np.zeros((SOUP_SLABS, 8), np.float32)
    tb[:, 0:3] = p.min(0).reshape(SOUP_SLABS, sweep.STREAM_T, 3).min(1)
    tb[:, 3:6] = p.max(0).reshape(SOUP_SLABS, sweep.STREAM_T, 3).max(1)
    return v0, e1, e2, tb


def _soup_ops(soup):
    """{use_bw: (16, T) operand} of the soup."""
    v0, e1, e2, _ = soup
    T = v0.shape[0]
    mt = np.concatenate([v0, e1, e2], 1).T
    bw = torch_scene._build_tri_bw(v0, e1, e2, T)

    def pad16(op):
        return np.ascontiguousarray(np.concatenate(
            [op, np.zeros((16 - op.shape[0], T), np.float32)]))

    return {True: pad16(bw), False: pad16(mt)}


def _soup_rays(kind, seed):
    """(8, 768) rays along +x.  'escape': from x = -1 at random y, z,
    maxt 1e30 (most cross every slab box and hit nothing: they hold
    their rows open), one ray tile idle; 'tie': the first tile aimed at
    the doubled triangle (every ray hits both copies at the same t), the
    rest escaping; 'zero': the first tile half starting on the doubled
    triangle with mint 0 (a -0 hit), half escaping."""
    rng = np.random.RandomState(seed)
    n = 768
    o = np.stack([np.full(n, -1.0), rng.rand(n) * 10, rng.rand(n) * 10], 1)
    d = np.tile([1.0, 0.0, 0.0], (n, 1))
    mint = np.full(n, 1e-4)
    maxt = np.full(n, 1e30)
    if kind == "escape":
        mint[512:], maxt[512:] = 1.0, -1.0
    else:
        m = 256 if kind == "tie" else 128
        a = rng.rand(m) * 0.45
        b = rng.rand(m) * (0.45 - a)
        o[:m, 1] = TIE_V0[1] + a
        o[:m, 2] = TIE_V0[2] + b
        if kind == "zero":
            o[:m, 0] = TIE_V0[0]
            mint[:m] = 0.0
    mint[300::17], maxt[300::17] = 1.0, -1.0
    return _pack(o.astype(np.float32), d.astype(np.float32),
                 mint.astype(np.float32), maxt.astype(np.float32))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _assert_plain(t, i, tp, ip, any_hit):
    np.testing.assert_array_equal(i >= 0, ip >= 0)
    if any_hit:
        return
    np.testing.assert_array_equal(i, ip)
    hit = ip >= 0
    np.testing.assert_array_equal(t[hit].view(np.int32),
                                  tp[hit].view(np.int32))


def _assert_jax(t, i, t_ref, i_ref, rows, rays, any_hit, rtol):
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    if any_hit:
        return
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol)
    for r in np.nonzero(hit & (i != i_ref))[0]:
        col = torch.from_numpy(rays[:, r:r + 1].copy())
        both = torch.from_numpy(rows[:, [i[r], i_ref[r]]].copy())
        ok, tt = sweep._pair_test(
            both, (col[0:1], col[1:2], col[2:3]),
            (col[3:4], col[4:5], col[5:6]), col[6:7], col[7:8])
        assert bool(ok.all())
        assert abs(float(tt[0, 0] - tt[0, 1])) <= rtol * abs(t_ref[r])


def _gate(ops, sub_t):
    """(sub_t, boxes) of the streamed soup whose MT rows are ops[False]:
    the scene's gate boxes at G (sweep.stream_sub_boxes), K5-cull's
    sub_block_boxes at another sub_t."""
    mt = _t(ops[False])
    return sub_t, (sweep.stream_sub_boxes(mt) if sub_t == G
                   else sweep.sub_block_boxes(mt, sub_t))


# (use_bw, any_hit, S, sub_t): the default gate at G on both operands,
# and K5-cull's sub-blocks of 128 (one a quarter) and 64 (two)
ROOM_CASES = [(True, False, 2, G), (False, False, 1, G), (True, True, 2, G),
              (False, True, 3, G), (False, False, 2, 128),
              (False, True, 1, 128), (False, False, 2, 64)]


@pytest.mark.parametrize("use_bw, any_hit, S, sub_t", ROOM_CASES)
def test_stream_split_room(slabbed, use_bw, any_hit, S, sub_t):
    """Living room rays through the plan and the work items, chunk-major
    and shuffled, gated per warp: BW and MT, closest and any-hit, at the
    scene's G and at K5-cull's 128 and 64; exactly the plain version's
    and the ungated walk's answer, with fewer sub-blocks tested."""
    ops, tb_s, rays, _ = slabbed
    if any_hit:
        rays = _shadow_rays(ops[False], rays)
    op, rt = _t(ops[use_bw]), _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), rt)
    tp, ip = (a.numpy() for a in sweep.stream_sweep_plain(op, rt, any_hit,
                                                          use_bw))
    gate = _gate(ops, sub_t)
    for seed in (None, 0, 1):
        t, i, visits, items, shut, _, culled, _ = stream_split(
            op, use_bw, keys, bits, rt, any_hit, S, seed, gate)
        _assert_plain(t, i, tp, ip, any_hit)
        assert len(items) >= 3 * Q * 2
    tu, iu, vu, _, _, _, cu, _ = stream_split(op, use_bw, keys, bits, rt,
                                              any_hit, S, None)
    _assert_plain(tu, iu, tp, ip, any_hit)
    assert cu == 0 and 0 < visits.sum() < vu.sum() and culled > 0
    cull_t = 0 if sub_t == G else sub_t
    t_ref, i_ref = (np.asarray(a) for a in pallas_mt.mt_sweep_streamed(
        jnp.asarray(ops[use_bw]), jnp.asarray(tb_s), jnp.asarray(rays),
        any_hit=any_hit, use_bw=use_bw, cull_t=cull_t))
    _assert_jax(t, i, t_ref, i_ref, ops[use_bw][:12 if use_bw else 9], rays,
                any_hit, 1e-5 if cull_t else 1e-6)
    assert (ip >= 0).sum() > 100 and (ip < 0).sum() > 40
    # the one-pass walk over whole slabs gives the same answer
    t1, i1, v1 = one_pass_stream(op, use_bw, keys, bits, rt, any_hit)
    _assert_plain(t1, i1, tp, ip, any_hit)
    assert v1.sum() > 0


def test_stream_split_culled_tests_fewer_groups(slabbed):
    """K5-cull's boxes of 128 gate coarser than the scene's of G: both
    skip sub-blocks and change no answer, the finer boxes skip more."""
    ops, tb_s, rays, _ = slabbed
    op, rt = _t(ops[False]), _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), rt)
    t0, i0, v0 = stream_split(op, False, keys, bits, rt, False, 2)[:3]
    t1, i1, v1 = stream_split(op, False, keys, bits, rt, False, 2,
                              gate=_gate(ops, 128))[:3]
    t2, i2, v2 = stream_split(op, False, keys, bits, rt, False, 2,
                              gate=_gate(ops, G))[:3]
    for t, i in ((t1, i1), (t2, i2)):
        np.testing.assert_array_equal(i0, i)
        np.testing.assert_array_equal(t0.view(np.int32), t.view(np.int32))
    assert 0 < v2.sum() < v1.sum() < v0.sum()


SOUP_CASES = [("escape", True, False), ("escape", False, False),
              ("escape", True, True), ("tie", True, False),
              ("tie", False, False), ("zero", True, False),
              ("escape", False, "cull"), ("tie", False, "cull")]


@pytest.mark.parametrize("kind, use_bw, any_hit", SOUP_CASES)
def test_stream_split_soup(soup, kind, use_bw, any_hit):
    """The synthetic soup, S 1, gated at G (K5-cull's 128 for "cull"):
    rays with maxt 1e30 that miss everything hold every slab's row open;
    an exact t tie whose two triangles fall in different work items (the
    lowest index wins, whatever the order of the items); a -0 hit (mint
    0, origin on the triangle) that keeps its sign through the packed
    best.  The ungated walk tests every sub-block of every slab in every
    warp of the escaping rows."""
    cull_t = 128 if any_hit == "cull" else 0
    any_hit = any_hit is True
    tb = soup[3]
    ops = _soup_ops(soup)
    op = _t(ops[use_bw])
    rays = _soup_rays(kind, 21)
    rt = _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb), rt)
    tp, ip = (a.numpy() for a in sweep.stream_sweep_plain(op, rt, any_hit,
                                                          use_bw))
    gate = _gate(ops, cull_t or G)
    for seed in (None, 0, 1):
        t, i, visits, items, shut, walks, _, _ = stream_split(
            op, use_bw, keys, bits, rt, any_hit, 1, seed, gate)
        _assert_plain(t, i, tp, ip, any_hit)
        assert len(items) >= 2 * SOUP_SLABS * Q // 2
    tu, iu, vu = stream_split(op, use_bw, keys, bits, rt, any_hit, 1)[:3]
    _assert_plain(tu, iu, tp, ip, any_hit)
    t_ref, i_ref = (np.asarray(a) for a in pallas_mt.mt_sweep_streamed(
        jnp.asarray(ops[use_bw]), jnp.asarray(tb), jnp.asarray(rays),
        any_hit=any_hit, use_bw=use_bw, cull_t=cull_t))
    _assert_jax(t, i, t_ref, i_ref, ops[use_bw][:12 if use_bw else 9], rays,
                any_hit, 1e-5)
    if kind == "escape":
        # every slab of the first two rows: most rays hit nothing
        # (its sub-blocks are slices across the soup in x: every +x ray
        # enters them all, so the gate skips none here)
        assert (vu[:2] == SOUP_SLABS * Q * (U // G) * NW).all()
        assert (visits[:2] <= vu[:2]).all()
        assert (ip[:512] < 0).mean() > 0.5 and visits[2] == 0
    else:
        m = 256 if kind == "tie" else 128
        assert (i[:m] == TIE_LO).all()
        lo = (TIE_LO // 512, TIE_LO % 512 // U)
        hi = (TIE_HI // 512, TIE_HI % 512 // U)
        w_lo = [w for w, v in enumerate(walks[0]) if lo in v]
        w_hi = [w for w, v in enumerate(walks[0]) if hi in v]
        assert w_lo and w_hi and set(w_lo).isdisjoint(w_hi)
        if kind == "zero":
            assert (t[:m].view(np.uint32) == 0x80000000).all()


def test_stream_split_shuts_items_beyond_the_skyline(soup):
    """Rays that all hit the doubled triangle close their row's skyline:
    chunk-major, the items of the later chunks are shut at the pull, and
    the answer is the plain version's."""
    ops = _soup_ops(soup)
    op = _t(ops[True])
    rays = _soup_rays("tie", 21)[:, :256].copy()
    rays[6], rays[7] = 1e-4, 1e30            # no idle lane keeps it open
    rt = _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(soup[3]), rt)
    tp, ip = (a.numpy() for a in sweep.stream_sweep_plain(op, rt))
    t, i, visits, items, shut, _, _, _ = stream_split(
        op, True, keys, bits, rt, False, 1, gate=_gate(ops, G))
    _assert_plain(t, i, tp, ip, False)
    assert (ip == TIE_LO).all() and shut >= Q
    assert visits[0] < len(items) * (U // G) * NW


# the gate's hard inputs: a 32 x 32 grid of 0.25-unit squares in the
# plane z = 5, two triangles a square, ordered so that each sub-block of
# G = 32 is a 4 x 4 patch (neighbouring sub-blocks share edges and
# vertices, and their boxes are flat in z); then the same grid tilted
# about x by 30 degrees and lifted, in 4 x 4 patches too, holding a copy
# of one flat triangle (GRID_TIE_HI) after its original (GRID_TIE_LO);
# then GRID_PAD padding triangles (points far away), sub-blocks of it only
GRID_PAD = 256


def _grid(rot):
    tri = []
    for py in range(8):
        for px in range(8):
            for qy in range(4):
                for qx in range(4):
                    x, y = (px * 4 + qx) * 0.25, (py * 4 + qy) * 0.25
                    tri.append([(x, y), (x + 0.25, y), (x, y + 0.25)])
                    tri.append([(x + 0.25, y + 0.25), (x, y + 0.25),
                                (x + 0.25, y)])
    p = np.array(tri, np.float64)                       # (2048, 3, 2)
    p3 = np.concatenate([p, np.full(p.shape[:2] + (1,), 5.0)], -1)
    if rot:
        c, s_ = np.cos(np.pi / 6), np.sin(np.pi / 6)
        y, z = p3[..., 1] - 4.0, p3[..., 2] - 5.0
        p3[..., 1], p3[..., 2] = 4.0 + c * y - s_ * z, 7.0 + s_ * y + c * z
    return p3


GRID_TIE_LO = 2 * (16 * 27 + 5)            # a flat triangle in patch 27
GRID_TIE_HI = 2048 + 2 * (16 * 9 + 6)      # its copy, in a tilted patch


@pytest.fixture(scope="module")
def gate_soup():
    """(ops {use_bw: (16, T)}, slab bounds): 4 flat slabs, 4 tilted ones
    (one triangle replaced by the flat tie copy) and a last slab of 256
    tilted triangles and GRID_PAD triangles of padding, as
    scene.compile_arrays pads."""
    flat, tilt = _grid(False), _grid(True)
    tilt[GRID_TIE_HI - 2048] = flat[GRID_TIE_LO]
    p = np.concatenate([flat, tilt, tilt[:256]]).astype(np.float32)
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    n = v0.shape[0]
    pad = (-n) % sweep.STREAM_T
    assert pad == GRID_PAD
    v0 = np.concatenate([v0, np.full((pad, 3), 1e30, np.float32)])
    e1 = np.concatenate([e1, np.zeros((pad, 3), np.float32)])
    e2 = np.concatenate([e2, np.zeros((pad, 3), np.float32)])
    T = v0.shape[0]
    mt = np.concatenate([v0, e1, e2], 1).T
    bw = torch_scene._build_tri_bw(v0, e1, e2, n)

    def pad16(op):
        return np.ascontiguousarray(np.concatenate(
            [op, np.zeros((16 - op.shape[0], T), np.float32)]))

    ops = {True: pad16(bw), False: pad16(mt)}
    q = np.stack([v0, v0 + e1, v0 + e2])
    valid = (np.arange(T) < n)[None, :, None]
    lo = np.where(valid, q, np.inf).min(0)
    hi = np.where(valid, q, -np.inf).max(0)
    n_s = T // sweep.STREAM_T
    tb = np.zeros((n_s, 8), np.float32)
    tb[:, 0:3] = lo.reshape(n_s, sweep.STREAM_T, 3).min(1)
    tb[:, 3:6] = hi.reshape(n_s, sweep.STREAM_T, 3).max(1)
    return ops, tb


def _gate_rays(ops, use_bw, any_hit):
    """(8, 768) rays: tile 0 straight down (d = -z, the clamped inverse
    in x and y) onto grid vertices and onto edges on patch borders, and
    rays grazing the flat grid at 1e-3; tile 1 starting inside the flat
    boxes (on the plane) in random directions, with a warp of dead
    lanes; tile 2 down onto the tie triangle's two copies, and along
    the tilted grid's normal onto its vertices.  Any-hit: maxt at the
    operand's own closest hit's t exactly on half the rays that hit."""
    rng = np.random.RandomState(8)
    o = np.zeros((768, 3))
    d = np.tile([0.0, 0.0, -1.0], (768, 1))
    grid = np.arange(33) * 0.25
    o[0:96, 0] = grid[rng.randint(0, 33, 96)]
    o[0:96, 1] = grid[rng.randint(0, 33, 96)]
    o[96:192, 0] = (rng.randint(0, 9, 96) * 1.0)           # patch borders
    o[96:192, 1] = rng.rand(96) * 8
    o[192:256, 0] = -0.5
    o[192:256, 1] = rng.rand(64) * 8
    d[192:256] = [1.0, 0.0, -1e-3]
    o[0:192, 2] = 10.0
    o[192:256, 2] = 5.0 + 1e-3 * (0.5 + rng.rand(64) * 8)
    o[256:512, 0:2] = rng.rand(256, 2) * 8
    o[256:512, 2] = 5.0
    w = rng.randn(256, 3)
    d[256:512] = w / np.linalg.norm(w, axis=1, keepdims=True)
    # square 5 of patch 27 starts at (3.25, 3.25); the tie is its lower
    # left triangle, under the tilted grid (z 6.6 there)
    o[512:640, 0] = 3.25 + 0.02 + rng.rand(128) * 0.08
    o[512:640, 1] = 3.25 + 0.02 + rng.rand(128) * 0.08
    o[512:640, 2] = 6.0
    nrm = np.array([0.0, -np.sin(np.pi / 6), np.cos(np.pi / 6)])
    o[640:768] = ops[False][0:3, 2048 + rng.randint(0, 2048, 128)].T \
        + 3.0 * nrm
    d[640:768] = -nrm
    mint = np.full(768, 1e-4)
    maxt = np.full(768, 1e30)
    mint[288:320], maxt[288:320] = 1.0, -1.0                # a dead warp
    rays = _pack(o.astype(np.float32), (d / np.linalg.norm(
        d, axis=1, keepdims=True)).astype(np.float32),
        mint.astype(np.float32), maxt.astype(np.float32))
    if any_hit:
        t, i = (a.numpy() for a in sweep.stream_sweep_plain(
            _t(ops[use_bw]), _t(rays), False, use_bw))
        exact = (i >= 0) & (np.arange(768) % 2 == 0)
        rays[7] = np.where(exact, t, np.where(i >= 0, t * 1.5, rays[7]))
    return rays


@pytest.mark.parametrize("sub_t", [G, 128, 64])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("use_bw", [True, False])
def test_stream_split_gate_hard_inputs(gate_soup, use_bw, any_hit, sub_t):
    """The per-warp gate on its hard inputs: rays along an axis onto
    vertices and edges that two sub-blocks share, rays grazing a plane,
    rays starting inside a box, an exact t tie across sub-blocks (the
    lower index wins), sub-blocks of padding only (empty boxes, never
    tested) and a warp whose lanes are all dead; any-hit rays whose
    maxt is their hit's t.  The gated walk, chunk-major and shuffled,
    gives the plain version's answer and the ungated walk's exactly."""
    ops, tb = gate_soup
    rays = _gate_rays(ops, use_bw, any_hit)
    op, rt = _t(ops[use_bw]), _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb), rt)
    tp, ip = (a.numpy() for a in sweep.stream_sweep_plain(op, rt, any_hit,
                                                          use_bw))
    gate = _gate(ops, sub_t)
    if sub_t == G:
        empty = ~(gate[1][:, 0] <= gate[1][:, 3]).numpy()
        assert empty.sum() == GRID_PAD // G
    for seed in (None, 0):
        t, i, visits, _, _, walks, culled, groups = stream_split(
            op, use_bw, keys, bits, rt, any_hit, 2, seed, gate)
        _assert_plain(t, i, tp, ip, any_hit)
    tu, iu, vu = stream_split(op, use_bw, keys, bits, rt, any_hit, 2)[:3]
    _assert_plain(tu, iu, tp, ip, any_hit)
    assert culled > 0 and (visits <= vu).all() and visits.sum() < vu.sum()
    assert (ip[0:96] >= 0).mean() > 0.9 and (ip[256:288] >= 0).any()
    assert (ip[288:320] < 0).all() and (ip[640:768] >= 0).mean() > 0.9
    if not any_hit:
        # the tie: both copies at the same t, the lower index wins
        assert (ip[512:640] == GRID_TIE_LO).all()
    # the walks reach the padding's quarters, but no warp tests them
    n_real = 4096 + 256
    assert any(j * 512 + q * U >= n_real for w in walks.values()
               for v in w for j, q in v)
    assert max(groups) < n_real


@pytest.mark.parametrize("streamed", [True, False])
def test_scene_sub_boxes(monkeypatch, streamed):
    """SceneData.tri_sub_boxes, built once by scene_data_from_numpy: on a
    streamed soup sub_block_boxes(tri_packed, G) except on the
    sub-blocks of padding only, which are empty (lo +inf, hi -inf); on a
    resident one a (1, 8) zero placeholder.  compile_arrays, the JAX
    package's dict, does not carry it."""
    from nori_tpu_torch import scenes_builtin as torch_scenes

    if streamed:
        monkeypatch.setattr(torch_scene, "STREAMED_BYTES", 9 * 1024 * 4)
    scene = torch_scenes.living_room(16, 16, 1, detail=3)
    assert "tri_sub_boxes" not in scene.compile_arrays()
    sd = scene.compile("cpu")
    got = sd.tri_sub_boxes
    if not streamed:
        assert sd.tri_packed.shape[0] == 9
        assert got.shape == (1, 8) and not got.any()
        return
    T = sd.tri_packed.shape[1]
    ref = sweep.sub_block_boxes(sd.tri_packed, G)
    pad = (torch.arange(T) >= scene.n_triangles).reshape(-1, G).all(1)
    assert got.shape == (T // G, 8) and got.is_contiguous()
    assert int(pad.sum()) >= 1
    assert torch.equal(got[~pad], ref[~pad])
    inf = float("inf")
    assert (got[pad, 0:3] == inf).all() and (got[pad, 3:6] == -inf).all()
    assert not got[:, 6:8].any()


# ---------------------------------------------------------------------------
# K6: the 2-D sweep's schedule
# ---------------------------------------------------------------------------

class _MtTile:
    """One ray tile's rays, the (9, T) soup and its order row."""

    def __init__(self, tris, rays, order, entry, bounds, scene, ah, cull):
        self.tris, self.rays, self.ah, self.cull = tris, rays, ah, cull
        self.ord, self.ent, self.bounds = order, entry, bounds
        r = rays.numpy()
        self.r = r
        self.live = r[6] <= r[7]
        e = r[0:3].T - scene[0:3]
        self.far = (np.sqrt((e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]
                             + e[:, 2] * e[:, 2]).astype(np.float32))
                    + np.float32(scene[3])).astype(np.float32)

    def search(self, bkey):
        return self.live & ~(bkey >= 0) if self.ah else self.live

    def reach(self, bt, bkey):
        """(t_hi, any, lo (3,), hi (3,)) as reach_partials/reach_read."""
        need = self.search(bkey)
        r = self.r
        cap = np.fmin(np.fmin(bt, r[7]), self.far)
        t_hi = np.float32(max(np.where(need, cap, 0).max(), 0))
        if not need.any():
            return t_hi, False, None, None
        o, d = r[0:3][:, need], r[3:6][:, need]
        lo = o.min(1) + t_hi * np.minimum(d.min(1), 0)
        hi = o.max(1) + t_hi * np.maximum(d.max(1), 0)
        return t_hi, True, lo.astype(np.float32), hi.astype(np.float32)

    def next_pass(self, p, j1, R):
        t_hi, any_need, lo, hi = R
        if not any_need:
            return j1
        while p < j1:
            if not self.cull:
                return p
            jj = self.ord[p]
            if not self.ent[jj] <= t_hi:
                return j1
            b = self.bounds[jj]
            if (hi >= b[0:3]).all() and (lo <= b[3:6]).all():
                return p
            p += 1
        return j1

    def quarter(self, j, q, bt, bkey, buv):
        r = self.rays
        o = (r[0][:, None], r[1][:, None], r[2][:, None])
        d = (r[3][:, None], r[4][:, None], r[5][:, None])
        lo = int(self.ord[j]) * sweep.TILE_T + q * sweep.TILE_U
        hit, t, u, v = sweep._pair_test_uv(
            self.tris[:, lo:lo + sweep.TILE_U], o, d, r[6][:, None],
            r[7][:, None])
        return _fold(bt, bkey, self.search(bkey), hit.numpy(), t.numpy(),
                     j * sweep.TILE_T + q * sweep.TILE_U,
                     (u.numpy(), v.numpy()), buv)

    def walk(self, j0, j1, quarters, best, buv, trace, out):
        """mt_walk as a generator that yields after every quarter:
        positions [j0, j1), the given quarters of each tile it tests,
        from and into the ray tile's packed bests; leaves (bt, bkey,
        reach, quarters tested) in out."""
        known = best.copy()
        bt, bkey = unpack_best(known)
        R = self.reach(bt, bkey)
        j, n = self.next_pass(j0, j1, R), 0
        while j < j1:
            for q in quarters:
                trace.append((j, q))
                bt, bkey = self.quarter(j, q, bt, bkey, buv)
                n += 1
                known, bt, bkey = _share(best, known, bt, bkey)
                yield
            R = self.reach(bt, bkey)
            j = self.next_pass(j + 1, j1, R)
        best[:] = np.minimum(best, pack_best(bt, bkey))
        out.update(bt=bt, bkey=bkey, R=R, tested=n)

    def finish(self, bt, bkey):
        """(t, idx, u, v): the triangle of a packed key, and its u and v
        recomputed by one pair test."""
        hit = bkey >= 0
        k = np.where(hit, bkey, 0)
        idx = np.where(hit, self.ord[k // sweep.TILE_T] * sweep.TILE_T
                       + k % sweep.TILE_T, -1)
        r = self.rays
        _, _, u, v = sweep._pair_test_uv(
            self.tris[:, torch.from_numpy(np.where(hit, idx, 0))],
            (r[0], r[1], r[2]), (r[3], r[4], r[5]), r[6], r[7])
        return (bt, idx, np.where(hit, u.numpy(), np.float32(0)),
                np.where(hit, v.numpy(), np.float32(0)))


def _mt_inputs(tris, tile_bounds, rays, cull):
    """(order, entry, coarse bounds) as sweep.mt_sweep builds them."""
    n_tt = tris.shape[1] // sweep.TILE_T
    n_rt = rays.shape[1] // N
    tb = sweep.coarse_bounds(tile_bounds, n_tt)
    if cull and n_tt > 1:
        entry = sweep.entry_min(tb, rays)
        order = torch.argsort(entry, dim=1, stable=True)
    else:
        entry = torch.zeros((n_rt, n_tt))
        order = torch.arange(n_tt).expand(n_rt, n_tt)
    return order.numpy(), entry.numpy(), tb.numpy()


def mt_split(tris, tile_bounds, scene, rays, any_hit, cull, S, seed=None):
    """K6's plan and work items; returns (t, idx, u, v, quarter visits
    per ray tile, items, shut items, walks)."""
    order, entry, tb = _mt_inputs(tris, tile_bounds, rays, cull)
    n_rt, n_tt = order.shape
    n = rays.shape[1]
    out = [np.full(n, F32_INF), np.full(n, -1, np.int64),
           np.zeros(n, np.float32), np.zeros(n, np.float32)]
    best = np.full(n, MISS, np.uint64)
    visits = np.zeros(n_rt, np.int64)
    tiles, records, pending, row_hi, walks = {}, [], {}, {}, {}
    for rt in range(n_rt):
        tile = _MtTile(tris, rays[:, rt * N:(rt + 1) * N], order[rt],
                       entry[rt], tb, scene, any_hit, cull)
        tiles[rt] = tile
        walks[rt] = []
        t_hi, any_need, _, _ = tile.reach(np.full(N, F32_INF),
                                          np.full(N, -1, np.int64))
        j_end = 0
        if any_need:
            j_end = (int((entry[rt][order[rt]] <= t_hi).sum()) if cull
                     else n_tt)
        if j_end:
            records.append((rt, 0, j_end))
            pending[rt] = -(-j_end // S) * Q
            row_hi[rt] = int(np.float32(t_hi).view(np.int32))
    items = _item_order(records, S, seed)
    state = dict(shut=0)
    item_out = {}

    def start(item):
        rt, j0, j1, q = item
        first = int(entry[rt][order[rt][j0]].view(np.int32))
        if row_hi[rt] < 0 or (cull and first > row_hi[rt]):
            state["shut"] += 1
            return None
        walks[rt].append([])
        item_out[item] = {}
        return tiles[rt].walk(j0, j1, (q,), best[rt * N:(rt + 1) * N],
                              [np.zeros(N, np.float32)] * 2, walks[rt][-1],
                              item_out[item])

    def done(item):
        rt = item[0]
        res = item_out.pop(item, None)
        if res is not None:
            visits[rt] += res["tested"]
            R = res["R"]
            row_hi[rt] = min(row_hi[rt],
                             int(R[0].view(np.int32)) if R[1] else -1)
        pending[rt] -= 1
        if pending[rt] == 0:
            sl = slice(rt * N, (rt + 1) * N)
            for a, b in zip(out, tiles[rt].finish(*unpack_best(best[sl]))):
                a[sl] = b

    _run_items(items, start, done, seed)
    assert all(v == 0 for v in pending.values())
    return (*out, visits, items, state["shut"], walks)


def one_pass_mt(tris, tile_bounds, scene, rays, any_hit, cull):
    """The walk the schedule replaces: one block per ray tile over its
    whole order row, whole tiles, the reach reduced before every tile,
    u and v carried with the hit; returns (t, idx, u, v, tiles tested
    per ray tile)."""
    order, entry, tb = _mt_inputs(tris, tile_bounds, rays, cull)
    n_rt, n_tt = order.shape
    n = rays.shape[1]
    out = [np.empty(n, np.float32), np.empty(n, np.int64),
           np.empty(n, np.float32), np.empty(n, np.float32)]
    visits = np.zeros(n_rt, np.int64)
    for rt in range(n_rt):
        tile = _MtTile(tris, rays[:, rt * N:(rt + 1) * N], order[rt],
                       entry[rt], tb, scene, any_hit, cull)
        buv = [np.zeros(N, np.float32), np.zeros(N, np.float32)]
        res = {}
        for _ in tile.walk(0, n_tt, range(Q), np.full(N, MISS, np.uint64),
                           buv, [], res):
            pass
        bt, bkey = res["bt"], res["bkey"]
        visits[rt] = res["tested"] // Q
        sl = slice(rt * N, (rt + 1) * N)
        _, idx, _, _ = tile.finish(bt, bkey)
        for a, b in zip(out, (bt, idx, buv[0], buv[1])):
            a[sl] = b
    return (*out, visits)


@pytest.fixture(scope="module")
def room9(slabbed):
    """The living room's (9, T) soup cut to whole 512-triangle tiles,
    its 128-triangle tile boxes and scene bounds."""
    js = jax_scenes.living_room(32, 32, 1, detail=3)
    jsd = js.compile()
    n_tt = np.asarray(jsd.tri_packed).shape[1] // sweep.TILE_T
    tris = np.ascontiguousarray(
        np.asarray(jsd.tri_packed)[:, :n_tt * sweep.TILE_T])
    tb = np.ascontiguousarray(np.asarray(jsd.tri_tile_bounds)[:n_tt * 4])
    return tris, tb, np.asarray(jsd.scene_bounds)


def _assert_mt(got, one, plain, tris, rays, any_hit):
    """The split schedule against the one-pass walk (everything equal:
    the fold is the same) and the dense plain version (t bits; triangles
    except at exact ties; u, v where the triangle is the same)."""
    t, i, u, v = got
    t1, i1, u1, v1 = one
    tp, ip, up, vp = plain
    hit = ip >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    np.testing.assert_array_equal(i1 >= 0, hit)
    if any_hit:
        return
    np.testing.assert_array_equal(i, i1)
    for a, b in ((t, t1), (u, u1), (v, v1)):
        np.testing.assert_array_equal(a[hit].view(np.int32),
                                      b[hit].view(np.int32))
    np.testing.assert_array_equal(t[hit].view(np.int32),
                                  tp[hit].view(np.int32))
    for r in np.nonzero(hit & (i != ip))[0]:
        col = torch.from_numpy(rays[:, r:r + 1].copy())
        ok, tt = sweep._pair_test(
            torch.from_numpy(tris[:, [i[r], ip[r]]].copy()),
            (col[0:1], col[1:2], col[2:3]), (col[3:4], col[4:5], col[5:6]),
            col[6:7], col[7:8])
        assert bool(ok.all()) and float(tt[0, 0]) == float(tt[0, 1])
    same = hit & (i == ip)
    np.testing.assert_array_equal(u[same].view(np.int32),
                                  up[same].view(np.int32))
    np.testing.assert_array_equal(v[same].view(np.int32),
                                  vp[same].view(np.int32))


@pytest.mark.parametrize("any_hit, cull, S", [(False, True, 2),
                                              (True, True, 1),
                                              (False, False, 3)])
def test_mt_split_room(room9, slabbed, any_hit, cull, S):
    """K6 on the living room: the split schedule, chunk-major and
    shuffled, equals the one-pass walk (t, idx, u, v bit for bit), the
    plain version and the JAX package's 2-D sweep in interpret mode."""
    tris, tb, scene = room9
    rays = slabbed[2]
    if any_hit:
        rays = _shadow_rays(slabbed[0][False], rays)
    args = (_t(tris), _t(tb), scene[0])
    rt = _t(rays)
    one = one_pass_mt(*args, rt, any_hit, cull)
    plain = tuple(a.numpy() for a in sweep.mt_sweep_plain(args[0], rt))
    for seed in (None, 0, 1):
        got = mt_split(*args, rt, any_hit, cull, S, seed)
        _assert_mt(got[:4], one[:4], plain, tris, rays, any_hit)
        assert len(got[5]) >= 3 * Q
    assert got[4].sum() > 0 and one[4].sum() > 0
    ref = pallas_mt.mt_sweep(jnp.asarray(tris), jnp.asarray(tb),
                             jnp.asarray(scene), jnp.asarray(rays),
                             any_hit=any_hit, cull=cull)
    t_ref, i_ref, u_ref, v_ref = (np.asarray(a) for a in ref)
    _assert_jax(got[0], got[1], t_ref, i_ref, tris, rays, any_hit, 1e-6)
    if not any_hit:
        same = (i_ref >= 0) & (got[1] == i_ref)
        np.testing.assert_allclose(got[2][same], u_ref[same], atol=1e-5)
        np.testing.assert_allclose(got[3][same], v_ref[same], atol=1e-5)


def test_mt_split_tie_keeps_the_earlier_tile(soup):
    """An exact tie in t between two tiles: +x rays enter the tile of
    TIE_HI first, so K6 keeps TIE_HI (the earlier visit) where the dense
    plain version keeps the lowest index; the split fold agrees with the
    one-pass walk in any order of the items, and the recomputed u and v
    are the in-walk ones bit for bit."""
    v0, e1, e2, tb = soup
    tris = np.ascontiguousarray(np.concatenate([v0, e1, e2], 1).T)
    scene = np.array([5, 5, 5, 9, 0, 0, 0, 0], np.float32)
    rays = _soup_rays("tie", 21)
    args = (_t(tris), _t(tb), scene)
    rt = _t(rays)
    one = one_pass_mt(*args, rt, False, True)
    plain = tuple(a.numpy() for a in sweep.mt_sweep_plain(args[0], rt))
    assert (one[1][:256] == TIE_HI).all() and (plain[1][:256] == TIE_LO).all()
    for seed in (None, 0, 1, 2):
        got = mt_split(*args, rt, False, True, 1, seed)
        _assert_mt(got[:4], one[:4], plain, tris, rays, False)
        walks = got[7][0]
        order = _mt_inputs(*args[:2], rt, True)[0][0]
        pos = {int(t): p for p, t in enumerate(order)}
        lo = (pos[TIE_LO // 512], TIE_LO % 512 // sweep.TILE_U)
        hi = (pos[TIE_HI // 512], TIE_HI % 512 // sweep.TILE_U)
        assert pos[TIE_HI // 512] < pos[TIE_LO // 512]
        w_lo = [w for w, v in enumerate(walks) if lo in v]
        w_hi = [w for w, v in enumerate(walks) if hi in v]
        assert w_lo and w_hi and set(w_lo).isdisjoint(w_hi)


# ---------------------------------------------------------------------------
# constants and scratch
# ---------------------------------------------------------------------------

def test_stream_constants_and_workspace():
    """sweep's STREAM_U / TILE_U / STREAM_S / MT_S are common.cuh's, and
    the workspace holds the packed best, one record per ray tile, the
    counters, the pending counts and the published skylines."""
    defines = {}
    with open(os.path.join(REPO, "nori_tpu_torch", "csrc", "common.cuh")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3 and parts[0] == "#define":
                defines[parts[1]] = parts[2]
    for name in ("STREAM_U", "TILE_U", "STREAM_S", "MT_S", "STREAM_T",
                 "TILE_N", "STREAM_G"):
        assert int(defines[name]) == getattr(sweep, name), name
    assert sweep.STREAM_T % sweep.STREAM_U == 0 == sweep.TILE_T % sweep.TILE_U
    n = 4 * sweep.TILE_N
    ws = sweep.stream_workspace(n, "cpu")
    assert ws.dtype == torch.int32
    assert ws.shape == (2 * n + 4 * 4 + 4 + 2 * 4,)
    ws.zero_()
    rec, cnt = 2 * n, 2 * n + 16
    ws[rec:rec + 8] = torch.tensor([0, 0, 9, 5, 2, 0, 5, 3])
    ws[cnt], ws[cnt + 2] = 2, 5
    assert sweep.stream_work(ws, n) == dict(records=2, max_chunks=5,
                                            items=8 * Q)
    assert defines["GATE_PAD"] == "0x1p-12f" and sweep.GATE_PAD == 2.0 ** -12
    assert sweep.STREAM_U % sweep.STREAM_G == 0
    with pytest.raises(ValueError):
        sweep._stream_ptrs(ws[:-1], n, torch.device("cpu"))


def test_stream_workspace_must_be_aligned():
    """A workspace that starts one int32 into an allocation is long
    enough but not 16-byte aligned: the 64-bit atomics on the packed
    bests and the 16-byte record loads would be misaligned on the card,
    so the wrapper refuses it."""
    n = 2 * sweep.TILE_N
    words = sweep.stream_workspace(n, "cpu").shape[0]
    big = torch.empty((words + 4,), dtype=torch.int32)
    off = (-big.data_ptr() // 4) % 4   # words up to the next 16-byte line
    aligned = big[off:off + words]
    kept, ptrs = sweep._stream_ptrs(aligned, n, torch.device("cpu"))
    assert kept is aligned and ptrs[0] == aligned.data_ptr()
    assert all(p % 16 == 0 for p in ptrs)
    with pytest.raises(ValueError, match="aligned"):
        sweep._stream_ptrs(big[off + 1:off + 1 + words], n,
                           torch.device("cpu"))


# ---------------------------------------------------------------------------
# the needed work that chip_smoke.py's bounds count
# ---------------------------------------------------------------------------

def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("use_bw, any_hit, sub_t", [
    (True, False, G), (False, False, G), (True, True, G), (False, False, 128),
    (False, True, 128), (False, False, 64)])
def test_keys_needed_bounds_every_schedule(slabbed, use_bw, any_hit, sub_t):
    """chip_smoke.keys_needed reads only the inputs and the plain
    answer, so it is the same for every schedule, and no schedule tests
    fewer groups in any ray tile: not the one-pass walk in key order
    (slabs), not the gated work items chunk-major or shuffled (per
    warp, the sub-blocks of the gate's boxes, each at least sub_t / G
    warp sub-blocks of G)."""
    cs = _chip_smoke()
    ops, tb_s, rays, _ = slabbed
    if any_hit:
        rays = _shadow_rays(ops[False], rays)
    op, rt = _t(ops[use_bw]), _t(rays)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), rt)
    plain = sweep.stream_sweep_plain(op, rt, any_hit, use_bw)
    gate = _gate(ops, sub_t)
    needed = cs.keys_needed(keys, bits, rt, plain, any_hit, gate[1],
                            per_warp=True).numpy()
    assert needed.sum() > 0
    for seed in (None, 0, 1):
        visits = stream_split(op, use_bw, keys, bits, rt, any_hit, 2, seed,
                              gate)[2]
        assert (needed * max(1, sub_t // G) <= visits).all()
    slabs = cs.keys_needed(keys, bits, rt, plain, any_hit).numpy()
    v1 = one_pass_stream(op, use_bw, keys, bits, rt, any_hit)[2]
    assert slabs.sum() > 0 and (slabs <= v1).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_needed_bounds_every_schedule(room9, slabbed, any_hit):
    """chip_smoke.mt_needed, from the inputs and the plain answer alone,
    never exceeds the tiles K6's culled walk tests in a ray tile, one
    pass or split, in any order of the items."""
    from types import SimpleNamespace

    cs = _chip_smoke()
    tris, tb, scene = room9
    rays = slabbed[2]
    if any_hit:
        rays = _shadow_rays(slabbed[0][False], rays)
    rt = _t(rays)
    sd = SimpleNamespace(tri_packed=_t(tris), tri_tile_bounds=_t(tb),
                         scene_bounds=_t(scene))
    needed = cs.mt_needed(sd, rt, sweep.mt_sweep_plain(sd.tri_packed, rt),
                          any_hit).numpy()
    assert needed.sum() > 0
    args = (sd.tri_packed, sd.tri_tile_bounds, scene[0])
    assert (needed <= one_pass_mt(*args, rt, any_hit, True)[4]).all()
    for seed in (None, 0, 1):
        visits = mt_split(*args, rt, any_hit, True, 2, seed)[4]
        assert (needed * Q <= visits).all()
