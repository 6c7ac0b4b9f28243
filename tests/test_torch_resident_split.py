"""The two-pass schedule of the resident sweep (csrc/resident_sweep.cu,
K2 / K2-mxu / K4), emulated on the CPU, against the dense plain versions
and the JAX package's resident sweep; and the port's own copy of the
native runtime source.

The emulation runs the kernel's schedule step by step: a first pass per
ray tile capped at V visits, the rest of a row that still passes the
skyline cut into items of S keys, the items taken in a shuffled order,
each starting from the packed per-ray best and folding into it with the
packed-word minimum (pack_best), the last item of a ray tile writing its
answers.  V and S are small here so that rows spill.

Tolerances: against the plain version (the same pair-test rounding),
exact: equal hit masks and, for closest hits, equal triangles and equal
t bits.  Against the JAX package, as tests/test_torch_sweep.py: hit
masks equal, t within rtol 1e-6, triangles equal except where the two
candidates' t tie within 1e-6 (the TPU kernel keeps the earlier visit
at an exact tie).  On the synthetic soup t within rtol 1e-5: its
triangles are 0.08 across and seen from up to 11 units, which turns
the two frameworks' different roundings of the same arithmetic into up
to 1.6e-6 of relative difference in t.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu.accel import pallas_mt
from nori_tpu.scenes_builtin import living_room as jax_living_room

from nori_tpu_torch import native
from nori_tpu_torch import scene as torch_scene
from nori_tpu_torch.accel import sweep
from nori_tpu_torch.scenes_builtin import living_room as torch_living_room

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISS = 0xFF800000FFFFFFFF
F32_INF = np.float32(np.inf)


# ---------------------------------------------------------------------------
# the packed best (resident_sweep.cu pack_best / unpack_best)
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


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

class _Tile:
    """One ray tile's rays and the operand, for the emulated walk."""

    def __init__(self, op, kind, rays, ah):
        self.op, self.kind, self.ah = op, kind, ah
        self.rays = rays                                   # (8, 256) tensor
        r = rays.numpy()
        self.live = r[6] <= r[7]
        self.maxt = r[7]
        if kind == "mxu":
            self.w4 = sweep._mxu_weights(op)

    def test(self, j):
        """(hit, t), each (256, FINE_T) numpy, against tile j."""
        r = self.rays
        o = (r[0][:, None], r[1][:, None], r[2][:, None])
        d = (r[3][:, None], r[4][:, None], r[5][:, None])
        cols = slice(j * sweep.FINE_T, (j + 1) * sweep.FINE_T)
        if self.kind == "mxu":
            hit, t = sweep._mxu_pair_test(self.w4[:, :, cols], o, d,
                                          r[6][:, None], r[7][:, None])
        else:
            hit, t = sweep._pair_test(self.op[:, cols], o, d, r[6][:, None],
                                      r[7][:, None])
        return hit.numpy(), t.numpy()

    def skyline(self, bt, bi):
        """(t_hi as int bits, alive), as the kernel's reduction."""
        need = self.live & ~(self.ah & (bi >= 0)) if self.ah else self.live
        tc = np.where(need, np.fmin(bt, self.maxt), np.float32(0))
        tc = np.where(tc > 0, tc, np.float32(0)).astype(np.float32)
        t_hi = int(tc.view(np.int32).max())
        return t_hi, (bool(need.any()) if self.ah else t_hi > 0)

    def walk(self, row, mask, k0, k1, vmax, bt, bi, trace):
        """The kernel's walk of keys row[k0:k1], at most vmax visits;
        returns (first key not visited, visits, t_hi, alive, bt, bi)."""
        t_hi, alive = self.skyline(bt, bi)

        def passes(k):
            return int(row[k] & ~mask) <= t_hi

        k, nv = k0, 0
        if not (alive and k < k1 and vmax > 0 and passes(k)):
            return k, nv, t_hi, alive, bt, bi
        while True:
            j = int(row[k] & mask)
            nxt = k + 1 < k1 and nv + 1 < vmax and passes(k + 1)
            nv += 1
            trace.append(j)
            search = self.live & ~(self.ah & (bi >= 0))
            hit, t = self.test(j)
            base = j * sweep.FINE_T
            for c in range(sweep.FINE_T):
                better = search & hit[:, c] & (
                    (t[:, c] < bt) | ((t[:, c] == bt) & (base + c < bi)))
                bt = np.where(better, t[:, c], bt)
                bi = np.where(better, base + c, bi)
            t_hi, alive = self.skyline(bt, bi)
            k += 1
            if not (alive and nxt and passes(k)):
                return k, nv, t_hi, alive, bt, bi


def split_sweep(op, kind, keys, idx_bits, rays, tile_ah, V, S, seed=0):
    """The two-pass schedule on (8, N) rays; returns (t, idx, visits per
    ray tile, items, walks: the tiles each walk visited, per ray tile)."""
    keys = keys.numpy()
    n = rays.shape[1]
    n_rt = n // sweep.TILE_N
    mask = (1 << idx_bits) - 1
    n_keys = keys.shape[1]
    t_out = np.empty(n, np.float32)
    i_out = np.empty(n, np.int64)
    best = np.empty(n, np.uint64)
    visits = np.zeros(n_rt, np.int64)
    items, pending, walks, tiles = [], {}, {}, {}
    for rt in range(n_rt):
        sl = slice(rt * sweep.TILE_N, (rt + 1) * sweep.TILE_N)
        tile = _Tile(op, kind, rays[:, sl], bool(tile_ah[rt]))
        tiles[rt] = tile
        walks[rt] = [[]]
        bt = np.full(sweep.TILE_N, F32_INF)
        bi = np.full(sweep.TILE_N, -1, np.int64)
        k, nv, t_hi, alive, bt, bi = tile.walk(keys[rt], mask, 0, n_keys, V,
                                               bt, bi, walks[rt][0])
        visits[rt] = nv
        if not (nv == V and alive and k < n_keys
                and int(keys[rt, k] & ~mask) <= t_hi):
            t_out[sl], i_out[sl] = bt, bi
            continue
        k_end = k + int(((keys[rt, k:] & ~mask) <= t_hi).sum())
        segs = [(rt, a, min(a + S, k_end)) for a in range(k, k_end, S)]
        items += segs
        pending[rt] = len(segs)
        best[sl] = pack_best(bt, bi)
    for n_item in np.random.default_rng(seed).permutation(len(items)):
        rt, a, b = items[n_item]
        sl = slice(rt * sweep.TILE_N, (rt + 1) * sweep.TILE_N)
        p0 = best[sl].copy()
        bt, bi = unpack_best(p0)
        walks[rt].append([])
        _, nv, _, _, bt, bi = tiles[rt].walk(keys[rt], mask, a, b, b - a, bt,
                                             bi, walks[rt][-1])
        visits[rt] += nv
        best[sl] = np.minimum(best[sl], pack_best(bt, bi))
        pending[rt] -= 1
        if pending[rt] == 0:
            t_out[sl], i_out[sl] = unpack_best(best[sl])
    return t_out, i_out, visits, items, walks


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def room():
    return (jax_living_room(32, 32, 1, detail=3).compile(),
            torch_living_room(32, 32, 1, detail=3).compile("cpu"))


def _pack(o, d, mint, maxt):
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))


def _room_rays(jsd, seed):
    """(8, 768): camera rays through random pixels, then bounce-like
    rays from random points in the scene bounds (maxt 1e30); every 17th
    lane idle."""
    cam = jax_living_room(32, 32, 1, detail=3).camera
    rng = np.random.RandomState(seed)
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
    return _pack(np.concatenate([o_c, o_b]), np.concatenate([d_c, d_b]),
                 mint, maxt)


def _room_shadow(tsd, rays):
    """Shadow segments from the closest hits of `rays` to random points
    near the scene's centre (idle where there is no hit)."""
    r = torch.from_numpy(rays)
    t, i = sweep.resident_sweep_plain(tsd.tri_bw, r)
    t, i = t.numpy(), i.numpy()
    rng = np.random.RandomState(3)
    p = rays[0:3].T + np.where(i >= 0, t, 0)[:, None] * rays[3:6].T
    c = np.asarray(tsd.scene_bounds)[0, 0:3]
    y = c + (rng.rand(p.shape[0], 3) - 0.5) * 2.0
    w = y - p
    dist = np.linalg.norm(w, axis=1)
    w = w / np.maximum(dist, 1e-6)[:, None]
    mint = np.full(p.shape[0], 1e-4, np.float32)
    maxt = np.where(i >= 0, dist * (1 - 1e-3), -1.0).astype(np.float32)
    return _pack(p.astype(np.float32), w.astype(np.float32), mint, maxt)


# the synthetic soup: 16 tiles of 128 small triangles in [0, 10]^3, the
# tiles in order of decreasing x, and one axis-aligned triangle in the
# plane x = 7 twice: index TIE_LO in tile 1 (visited late by +x rays)
# and TIE_HI in tile 12 (visited early)
TIE_LO, TIE_HI = 130, 12 * 128 + 5
TIE_V0 = np.array([7.0, 5.0, 5.0], np.float32)
TIE_E1 = np.array([0.0, 0.5, 0.0], np.float32)
TIE_E2 = np.array([0.0, 0.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def soup():
    """(v0, e1, e2) numpy (T, 3), tile bounds (16, 8)."""
    rng = np.random.RandomState(5)
    T = 16 * sweep.FINE_T
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
    lo = p.min(0).reshape(16, sweep.FINE_T, 3).min(1)
    hi = p.max(0).reshape(16, sweep.FINE_T, 3).max(1)
    tb = np.zeros((16, 8), np.float32)
    tb[:, 0:3], tb[:, 3:6] = lo, hi
    return v0, e1, e2, tb


def _soup_rays(kind, seed):
    """(8, 768) rays along +x.  'escape': from x = -1 at random y, z,
    maxt 1e30 (most cross every tile box and hit nothing), one ray tile
    idle; 'tie': the first tile aimed at the doubled triangle (every ray
    hits both copies at the same t), the rest escaping; 'zero': the
    first tile half starting on the doubled triangle with mint 0 (a -0
    hit), half escaping."""
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


def _assert_jax(t, i, t_ref, i_ref, op, rays, any_hit, rtol=1e-6):
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    if any_hit:
        return
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol)
    for r in np.nonzero(hit & (i != i_ref))[0]:
        col = torch.from_numpy(rays[:, r:r + 1].copy())
        both = torch.from_numpy(op[:, [i[r], i_ref[r]]].copy())
        ok, tt = sweep._pair_test(
            both, (col[0:1], col[1:2], col[2:3]),
            (col[3:4], col[4:5], col[5:6]), col[6:7], col[7:8])
        assert bool(ok.all())
        assert abs(float(tt[0, 0] - tt[0, 1])) <= rtol * abs(t_ref[r])


def _spilled(items):
    """(ray tiles that spilled, work items)."""
    return len({rt for rt, _, _ in items}), len(items)


ROOM_CASES = [("bw", False, 2, 2), ("mt", False, 2, 3), ("bw", True, 3, 2),
              ("mt", True, 1, 1), ("bw", "mixed", 2, 2)]


@pytest.mark.parametrize("use, any_hit, V, S", ROOM_CASES)
def test_split_room(room, use, any_hit, V, S):
    """Living room rays (camera, bounce with maxt 1e30, idle lanes):
    closest, any-hit, and a mixed launch of both whose items share the
    work list (taken in a shuffled order)."""
    jsd, tsd = room
    rays = _room_rays(jsd, 11)
    if any_hit is True:
        rays = _room_shadow(tsd, rays)
    flags = np.zeros(rays.shape[1] // 256, np.int32)
    if any_hit == "mixed":
        rays = np.ascontiguousarray(np.concatenate(
            [rays, _room_shadow(tsd, rays)], axis=1))
        flags = (np.arange(rays.shape[1] // 256) >= 3).astype(np.int32)
    elif any_hit:
        flags[:] = 1
    top = tsd.tri_bw if use == "bw" else tsd.tri_packed
    rt = torch.from_numpy(rays)
    keys, bits = sweep.ray_tile_entry_keys(tsd.tri_tile_bounds, rt)
    t, i, visits, items, _ = split_sweep(top, use, keys, bits, rt, flags, V,
                                         S)
    n_spilled, n_items = _spilled(items)
    assert n_spilled >= 1 and n_items >= 2
    tp, ip = (a.numpy() for a in sweep.resident_sweep_plain(top, rt))
    ah_ray = np.repeat(flags, 256).astype(bool)
    jop = jsd.tri_bw if use == "bw" else jsd.tri_packed
    if any_hit == "mixed":
        t_ref, i_ref = pallas_mt.mt_sweep_resident_mixed(
            jop, jsd.tri_tile_bounds, jsd.scene_bounds, jnp.asarray(rays),
            jnp.asarray(flags), use_bw=use == "bw")
    else:
        t_ref, i_ref = pallas_mt.mt_sweep_resident(
            jop, jsd.tri_tile_bounds, jsd.scene_bounds, jnp.asarray(rays),
            any_hit=bool(any_hit), use_bw=use == "bw")
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    for sel, ah in ((~ah_ray, False), (ah_ray, True)):
        if not sel.any():
            continue
        _assert_plain(t[sel], i[sel], tp[sel], ip[sel], ah)
        _assert_jax(t[sel], i[sel], t_ref[sel], i_ref[sel], top.numpy(),
                    rays[:, sel], ah)
    assert (ip >= 0).sum() > 100


def test_split_room_mxu(room):
    """K2-mxu's operand through the same schedule, against its plain
    version exactly (the JAX package's MXU sweep sums in XLA's order;
    tests/test_torch_mixed.py bounds that)."""
    _, tsd = room
    rays = torch.from_numpy(_room_rays(room[0], 12))
    keys, bits = sweep.ray_tile_entry_keys(tsd.tri_tile_bounds, rays)
    flags = np.zeros(rays.shape[1] // 256, np.int32)
    t, i, _, items, _ = split_sweep(tsd.tri_mxu, "mxu", keys, bits, rays,
                                    flags, 2, 2)
    assert _spilled(items)[1] >= 2
    tp, ip = (a.numpy() for a in sweep.resident_sweep_mxu_plain(tsd.tri_mxu,
                                                                rays))
    _assert_plain(t, i, tp, ip, False)


SOUP_CASES = [("escape", "bw", False, 3), ("escape", "mt", False, 3),
              ("escape", "bw", True, 3), ("tie", "bw", False, 3),
              ("tie", "mt", False, 3), ("zero", "bw", False, 2)]


@pytest.mark.parametrize("kind, use, any_hit, V", SOUP_CASES)
def test_split_soup(soup, kind, use, any_hit, V):
    """Long rows on the synthetic soup, S 2: rays with maxt 1e30
    that miss everything hold every tile's walk open; an exact t tie
    whose two triangles fall in different walks (the lowest index wins,
    whatever the order of the items); a -0 hit (mint 0, origin on the
    triangle) that keeps its sign through the packed best."""
    v0, e1, e2, tb = soup
    T = v0.shape[0]
    top = (torch.from_numpy(torch_scene._build_tri_bw(v0, e1, e2, T))
           if use == "bw" else
           torch.from_numpy(np.ascontiguousarray(
               np.concatenate([v0, e1, e2], 1).T)))
    rays = _soup_rays(kind, 21)
    rt = torch.from_numpy(rays)
    tbt = torch.from_numpy(tb)
    keys, bits = sweep.ray_tile_entry_keys(tbt, rt)
    flags = np.full(rays.shape[1] // 256, int(any_hit), np.int32)
    tp, ip = (a.numpy() for a in sweep.resident_sweep_plain(top, rt))
    for seed in (0, 1):
        t, i, visits, items, walks = split_sweep(top, use, keys, bits, rt,
                                                 flags, V, 2, seed)
        _assert_plain(t, i, tp, ip, any_hit)
        assert len(items) >= 10
    t_ref, i_ref = (np.asarray(a) for a in pallas_mt.mt_sweep_resident(
        jnp.asarray(top.numpy()), jnp.asarray(tb), jnp.zeros((1, 8)),
        jnp.asarray(rays), any_hit=any_hit, use_bw=use == "bw"))
    _assert_jax(t, i, t_ref, i_ref, top.numpy(), rays, any_hit, rtol=1e-5)
    if kind == "escape":
        # rows of every tile: most rays hit nothing
        assert (visits[:2] >= 12).all() and (ip[:512] < 0).mean() > 0.8
        assert visits[2] == 0
    else:
        m = 256 if kind == "tie" else 128
        assert (i[:m] == TIE_LO).all()
        lo_tile, hi_tile = TIE_LO // 128, TIE_HI // 128
        w_lo = [w for w, tiles in enumerate(walks[0]) if lo_tile in tiles]
        w_hi = [w for w, tiles in enumerate(walks[0]) if hi_tile in tiles]
        assert w_lo and w_hi and set(w_lo).isdisjoint(w_hi)
        if kind == "zero":
            assert (t[:m].view(np.uint32) == 0x80000000).all()


def test_pack_best_orders_as_the_fold():
    """The packed word's order is the fold's: the smallest t (-0 equal
    to +0), then the lowest index; a miss is the largest; unpack
    restores t's bits, -0 included."""
    rng = np.random.RandomState(2)
    t = np.concatenate([rng.rand(300).astype(np.float32) * 5,
                        np.float32([0.0, -0.0, 0.0, -0.0, 1.5, 1.5, -2.0,
                                    3e38, 1e-40])])
    i = np.concatenate([rng.randint(0, 1 << 22, 300),
                        [7, 3, 8, 9, 4, 2, 1, 5, 6]])
    p = pack_best(t, i)
    for a in range(len(t)):
        for b in range(0, len(t), 7):
            fold_less = t[a] < t[b] or (t[a] == t[b] and i[a] < i[b])
            assert (p[a] < p[b]) == fold_less
    assert (p < np.uint64(MISS)).all()
    tu, iu = unpack_best(p)
    np.testing.assert_array_equal(tu.view(np.uint32), t.view(np.uint32))
    np.testing.assert_array_equal(iu, i)
    tm, im = unpack_best(pack_best(np.float32([np.inf]), [-1]))
    assert np.isinf(tm[0]) and im[0] == -1


def test_resident_constants_and_workspace():
    """sweep.RESIDENT_V / RESIDENT_S are common.cuh's, and the workspace
    holds the packed best, the worst-case work list, the counters and
    the pending counts."""
    defines = {}
    with open(os.path.join(REPO, "nori_tpu_torch", "csrc", "common.cuh")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3 and parts[0] == "#define":
                defines[parts[1]] = parts[2]
    assert int(defines["RESIDENT_V"]) == sweep.RESIDENT_V
    assert int(defines["RESIDENT_S"]) == sweep.RESIDENT_S
    assert int(defines["TILE_N"]) == sweep.TILE_N
    n, n_keys = 4 * sweep.TILE_N, 404
    cap = 4 * -(-n_keys // sweep.RESIDENT_S)
    ws = sweep.resident_workspace(n, n_keys, "cpu")
    assert ws.dtype == torch.int32
    assert ws.shape == (2 * n + 4 * cap + 2 + 4,)
    ws[2 * n + 4 * cap] = 17
    assert sweep.tail_items(ws, n, n_keys) == 17


def test_native_source_is_the_ports_own_copy():
    """The port builds its native runtime from its own copy of the JAX
    package's source, byte for byte, and reads nothing under
    nori_tpu/."""
    ours = os.path.join(REPO, "nori_tpu_torch", "csrc", "nori_native.cpp")
    theirs = os.path.join(REPO, "nori_tpu", "native", "nori_native.cpp")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    src = os.path.realpath(native._SRC)
    assert src == os.path.realpath(ours)
    assert os.path.commonpath(
        [src, os.path.join(REPO, "nori_tpu_torch")]) == os.path.join(
            REPO, "nori_tpu_torch")
