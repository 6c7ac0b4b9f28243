"""The plain versions of the sweep kernels (nori_tpu_torch.accel.sweep)
against the JAX package's Pallas kernels run in interpret mode on the
CPU, on the living room at detail 3 (4,096 triangles, 32 tiles) with
768 mixed camera and bounce-like rays, idle lanes included.

Tolerances: K1 (entry distances and packed keys) and K3 (lane keys)
are bit-exact, except K3's fine field on lanes with a candidate at
offset >= 21 (the Pallas kernel reads the field out of a float sum
that such candidates can round into).  K2: hit masks equal, t within
rtol 1e-6, triangle indices equal except where two candidates' t tie
within 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu import config
from nori_tpu.accel import pallas_mt
from nori_tpu.scenes_builtin import living_room as jax_living_room

from nori_tpu_torch.accel import sweep
from nori_tpu_torch.scenes_builtin import living_room as torch_living_room

N_CAMERA, N_BOUNCE = 256, 512


@pytest.fixture(scope="module")
def scenes():
    return (jax_living_room(32, 32, 1, detail=3).compile(),
            torch_living_room(32, 32, 1, detail=3).compile("cpu"))


@pytest.fixture(scope="module")
def rays_np(scenes):
    """(8, 768) packed rays: camera rays through random pixels, then
    bounce-like rays from random points in the scene bounds in random
    directions; every 17th lane idle (mint > maxt)."""
    jsd, _ = scenes
    cam = jax_living_room(32, 32, 1, detail=3).camera
    rng = np.random.RandomState(11)
    pos = jnp.asarray((rng.rand(N_CAMERA, 2) * 32).astype(np.float32))
    o_c, d_c, mint_c, maxt_c = (
        np.asarray(a) for a in type(cam).sample_rays(cam.ray_params(), pos))
    center = np.asarray(jsd.scene_bounds)[0, 0:3]
    half = float(np.asarray(jsd.scene_bounds)[0, 3])
    o_b = (center + (rng.rand(N_BOUNCE, 3) - 0.5) * half).astype(np.float32)
    d_b = rng.randn(N_BOUNCE, 3).astype(np.float32)
    d_b /= np.linalg.norm(d_b, axis=1, keepdims=True)
    o = np.concatenate([o_c, o_b])
    d = np.concatenate([d_c, d_b])
    mint = np.concatenate([mint_c, np.full(N_BOUNCE, 1e-4, np.float32)])
    maxt = np.concatenate([maxt_c, np.full(N_BOUNCE, 1e30, np.float32)])
    mint[::17], maxt[::17] = 1.0, -1.0
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def test_entry_min_bit_exact(scenes, rays_np):
    jsd, tsd = scenes
    ref = np.asarray(pallas_mt._entry_min_pallas(
        jsd.tri_tile_bounds, jnp.asarray(rays_np), pallas_mt.TILE_N))
    got = sweep.entry_min_plain(tsd.tri_tile_bounds, _t(rays_np)).numpy()
    assert got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    assert np.isinf(got).any() and np.isfinite(got).any()


def test_entry_keys_bit_exact(scenes, rays_np):
    jsd, tsd = scenes
    ref, ref_bits = pallas_mt.ray_tile_entry_keys(
        jsd.tri_tile_bounds, jnp.asarray(rays_np), cap=None)
    got, bits = sweep.ray_tile_entry_keys(tsd.tri_tile_bounds, _t(rays_np))
    assert bits == ref_bits
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("use_bw", [True, False])
def test_resident_sweep_plain_matches_pallas(scenes, rays_np, use_bw,
                                             any_hit):
    jsd, tsd = scenes
    jop = jsd.tri_bw if use_bw else jsd.tri_packed
    t_ref, i_ref = pallas_mt.mt_sweep_resident(
        jop, jsd.tri_tile_bounds, jsd.scene_bounds, jnp.asarray(rays_np),
        any_hit=any_hit, use_bw=use_bw)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    top = tsd.tri_bw if use_bw else tsd.tri_packed
    t, i = sweep.resident_sweep_plain(top, _t(rays_np), any_hit)
    t, i = t.numpy(), i.numpy()
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    assert hit.sum() > 100 and (~hit).sum() > 40
    if any_hit:
        return
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-6)
    # a different winner is allowed only where its t ties the
    # reference winner's within 1e-6
    diff = hit & (i != i_ref)
    if diff.any():
        op = top.numpy()
        for r in np.nonzero(diff)[0]:
            col = torch.from_numpy(rays_np[:, r:r + 1].copy())
            both = torch.from_numpy(op[:, [i[r], i_ref[r]]].copy())
            ok, tt = sweep._pair_test(
                both, (col[0:1], col[1:2], col[2:3]),
                (col[3:4], col[4:5], col[5:6]), col[6:7], col[7:8])
            assert bool(ok.all())
            assert abs(float(tt[0, 0] - tt[0, 1])) <= 1e-6 * abs(t_ref[r])


def test_lane_keys_plain_matches_pallas(scenes, rays_np):
    jsd, tsd = scenes
    config.FORCE_PALLAS_INTERPRET = True
    try:
        r1, r2 = pallas_mt.lane_sort_keys(jsd.tri_tile_bounds,
                                          jnp.asarray(rays_np))
    finally:
        config.FORCE_PALLAS_INTERPRET = False
    r1, r2 = np.asarray(r1), np.asarray(r2)
    k1, k2 = (k.numpy() for k in sweep.lane_keys_plain(
        tsd.tri_tile_bounds, _t(rays_np)))
    np.testing.assert_array_equal(k2, r2)
    np.testing.assert_array_equal(k1 >> 20, r1 >> 20)
    # candidates at offsets >= 21 from the first one may round into
    # the Pallas kernel's float-sum fine field
    tb = np.asarray(jsd.tri_tile_bounds)
    o, dv = rays_np[0:3].T[:, None], rays_np[3:6].T[:, None]
    inv = 1.0 / np.where(np.abs(dv) < 1e-20,
                         np.where(dv < 0, -1e-20, 1e-20), dv)
    t0, t1 = (tb[None, :, 0:3] - o) * inv, (tb[None, :, 3:6] - o) * inv
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    mint, maxt = rays_np[6][:, None], rays_np[7][:, None]
    cand = (tn <= tf) & (tf >= mint) & (tn <= maxt) & (mint <= maxt)
    idx = np.arange(tb.shape[0])[None, :]
    first = np.where(cand, idx, tb.shape[0]).min(1)[:, None]
    far = (cand & (idx - first >= 21)).any(1)
    fine_eq = (k1 & 0xFFFFF) == (r1 & 0xFFFFF)
    assert fine_eq[~far].all()
    assert fine_eq.mean() >= 0.99


def test_wrappers_route_cpu_tensors_to_plain(scenes, rays_np):
    _, tsd = scenes
    rays = _t(rays_np)
    before = (sweep.entry_min.launches, sweep.resident_sweep.launches,
              sweep.lane_keys.launches)
    tb = tsd.tri_tile_bounds
    assert torch.equal(sweep.entry_min(tb, rays),
                       sweep.entry_min_plain(tb, rays))
    keys, bits = sweep.ray_tile_entry_keys(tb, rays)
    for any_hit in (False, True):
        t, i = sweep.resident_sweep(tsd.tri_bw, keys, bits, rays, any_hit)
        tp, ip = sweep.resident_sweep_plain(tsd.tri_bw, rays, any_hit)
        assert torch.equal(t, tp) and torch.equal(i, ip)
    for a, b in zip(sweep.lane_keys(tb, rays), sweep.lane_keys_plain(tb, rays)):
        assert torch.equal(a, b)
    assert (sweep.entry_min.launches, sweep.resident_sweep.launches,
            sweep.lane_keys.launches) == before == (0, 0, 0)


def test_wrappers_reject_bad_inputs(scenes, rays_np):
    _, tsd = scenes
    rays = _t(rays_np)
    tb = tsd.tri_tile_bounds
    with pytest.raises(ValueError):
        sweep.entry_min(tb, rays[:, :300].contiguous())   # ragged tile
    with pytest.raises(TypeError):
        sweep.entry_min(tb.double(), rays)
    with pytest.raises(ValueError):
        sweep.lane_keys(tb, rays.T.contiguous().T)        # not contiguous
    keys, bits = sweep.ray_tile_entry_keys(tb, rays)
    with pytest.raises(ValueError):
        sweep.resident_sweep(tsd.tri_bw[:10].contiguous(), keys, bits, rays)
    with pytest.raises(ValueError):
        sweep.resident_sweep(tsd.tri_bw, keys[:1].contiguous(), bits, rays)
    with pytest.raises(ValueError):
        sweep.resident_sweep(tsd.tri_bw, keys, 2, rays)   # 4 < 32 tiles


def test_pack_rays_pads_with_idle_rays():
    o = torch.zeros((300, 3))
    d = torch.ones((300, 3))
    rays, n = sweep.pack_rays(o, d, torch.zeros(300), torch.ones(300))
    assert n == 300 and tuple(rays.shape) == (8, 512)
    assert bool((rays[6, 300:] > rays[7, 300:]).all())
    assert bool((rays[6, :300] <= rays[7, :300]).all())


def test_lane_keys_past_2048_tiles():
    """The kernel stages tile boxes chunk by chunk, so any tile count is
    taken: 2,100 small boxes on a grid in the plane z = 0, rays from
    above (a few candidates each) and rays grazing the plane (many),
    against the JAX package's jnp keys."""
    rng = np.random.RandomState(4)
    n_tt = 2100
    gx, gy = np.meshgrid(np.arange(50), np.arange(42), indexing="ij")
    lo = np.stack([gx.ravel(), gy.ravel(), np.zeros(n_tt)], 1) * [1, 1, 0]
    tb = np.zeros((n_tt, 8), np.float32)
    tb[:, 0:3] = lo - [0, 0, 0.1]
    tb[:, 3:6] = lo + [0.8, 0.8, 0.1]
    n = 512
    o = np.concatenate([
        np.stack([rng.rand(n // 2) * 50, rng.rand(n // 2) * 42,
                  np.full(n // 2, 2.0)], 1),
        np.stack([rng.rand(n // 2) * 50, rng.rand(n // 2) * 42,
                  np.full(n // 2, 0.05)], 1)])
    d = np.concatenate([
        np.stack([rng.randn(n // 2) * 0.3, rng.randn(n // 2) * 0.3,
                  -np.ones(n // 2)], 1),
        np.stack([rng.randn(n // 2), rng.randn(n // 2),
                  np.zeros(n // 2)], 1)])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4)
    maxt = np.full(n, 1e30)
    mint[::13], maxt[::13] = 1.0, -1.0
    rays = np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))
    r1, r2 = (np.asarray(k) for k in pallas_mt._lane_keys_impl(
        jnp.asarray(tb), jnp.asarray(rays)))
    k1, k2 = (k.numpy() for k in sweep.lane_keys(_t(tb), _t(rays)))
    np.testing.assert_array_equal(k2, r2)
    np.testing.assert_array_equal(k1 >> 20, r1 >> 20)
    assert (k1 >> 20).max() == 1023 and len(np.unique(k2)) > 20
    # the fine field differs only where candidates at offsets >= 21
    # round into the reference's float sum
    o3, inv = rays[0:3].T[:, None], 1.0 / np.where(
        np.abs(rays[3:6].T) < 1e-20,
        np.where(rays[3:6].T < 0, -1e-20, 1e-20), rays[3:6].T)[:, None]
    t0, t1 = (tb[None, :, 0:3] - o3) * inv, (tb[None, :, 3:6] - o3) * inv
    tn, tf = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    cand = ((tn <= tf) & (tf >= rays[6][:, None]) & (tn <= rays[7][:, None])
            & (rays[6] <= rays[7])[:, None])
    idx = np.arange(n_tt)[None, :]
    first = np.where(cand, idx, n_tt).min(1)[:, None]
    far = (cand & (idx - first >= 21)).any(1)
    assert far.any() and (~far & cand.any(1)).sum() > 100
    fine_eq = (k1 & 0xFFFFF) == (r1 & 0xFFFFF)
    assert fine_eq[~far].all()
