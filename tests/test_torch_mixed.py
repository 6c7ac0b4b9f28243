"""The merged closest+shadow step and the matmul-form sweep of
nori_tpu_torch against nori_tpu, on the CPU.

K4's plain version and `traverse.intersect_mixed` are held against the
JAX package's mixed Pallas sweep (`mt_sweep_resident_mixed`, interpret
mode) on the living room at detail 3 (4,096 triangles, 32 tiles) with
768 camera and bounce-like rays and 768 shadow-like segments; K2-mxu's
plain version against `mt_sweep_resident(use_mxu=True)`.  Then the
merged wavefront: against the port's own two-launch step, across pool
widths, and against the JAX package's merged step; the gating of the
merged step; and lane order (sort_rays) against no sort.

Tolerances: hit masks and occlusion equal, t within rtol 1e-6,
triangles equal except where two candidates' t tie within 1e-6.  The
MXU form as tests/test_accel.py:108-112 bounds it against the MT sweep:
XLA's CPU dot sums in its own order and the numerators cancel, so idx
equal on >= 99.9% of rays and |dt| / max(t, 1e-3) < 1e-4 where equal.
Images: bit-equal where the port is held against itself (the merged
step and lane order change no sample's value); the exact image gate of
tests/test_torch_wavefront.py against the JAX package.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu import config as jax_config
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf
from nori_tpu.accel import pallas_mt
from nori_tpu.accel import traverse as jax_traverse

from nori_tpu_torch import config as torch_config
from nori_tpu_torch import scene as torch_scene_mod
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.accel import sweep
from nori_tpu_torch.accel import traverse as torch_traverse
from nori_tpu_torch.integrators.path import EMS, MATS, MIS

from torch_threads import one_torch_thread  # noqa: F401

N_CAMERA, N_BOUNCE = 256, 512


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.fixture(scope="module")
def scenes():
    return (jax_scenes.living_room(32, 32, 1, detail=3).compile(),
            torch_scenes.living_room(32, 32, 1, detail=3).compile("cpu"))


@pytest.fixture(scope="module")
def ray_sets(scenes):
    """(o, d, mint, maxt) of 768 closest-hit rays (camera rays through
    random pixels, then bounce-like rays from random points of the
    scene in random directions) and (o, d, mint, maxt) of 768 shadow-like
    segments from the same origins; every 17th lane idle in both."""
    jsd, _ = scenes
    cam = jax_scenes.living_room(32, 32, 1, detail=3).camera
    rng = np.random.RandomState(11)
    pos = jnp.asarray((rng.rand(N_CAMERA, 2) * 32).astype(np.float32))
    o_c, d_c, mint_c, maxt_c = (
        np.asarray(a) for a in type(cam).sample_rays(cam.ray_params(), pos))
    center = np.asarray(jsd.scene_bounds)[0, 0:3]
    half = float(np.asarray(jsd.scene_bounds)[0, 3])
    o_b = (center + (rng.rand(N_BOUNCE, 3) - 0.5) * half).astype(np.float32)
    d_b = rng.randn(N_BOUNCE, 3).astype(np.float32)
    d_b /= np.linalg.norm(d_b, axis=1, keepdims=True)
    o = np.concatenate([o_c, o_b]).astype(np.float32)
    d = np.concatenate([d_c, d_b]).astype(np.float32)
    mint = np.concatenate([mint_c, np.full(N_BOUNCE, 1e-4, np.float32)])
    maxt = np.concatenate([maxt_c, np.full(N_BOUNCE, 1e30, np.float32)])
    mint[::17], maxt[::17] = 1.0, -1.0
    n = o.shape[0]
    d_s = rng.randn(n, 3).astype(np.float32)
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    mint_s = np.full(n, 1e-4, np.float32)
    maxt_s = (rng.rand(n) * half).astype(np.float32)
    mint_s[::17], maxt_s[::17] = 1.0, -1.0
    return (o, d, mint.astype(np.float32), maxt.astype(np.float32)), (
        o, d_s, mint_s, maxt_s)


def _pack(rs):
    o, d, mint, maxt = rs
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))


def _assert_closest(t, i, t_ref, i_ref, rows, rays_np):
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    assert hit.sum() > 100 and (~hit).sum() > 40
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-6)
    # a different winner only where both triangles are hit and their t
    # tie within 1e-6
    for r in np.nonzero(hit & (i != i_ref))[0]:
        col = torch.from_numpy(rays_np[:, r:r + 1].copy())
        both = torch.from_numpy(rows[:, [i[r], i_ref[r]]].copy())
        ok, tt = sweep._pair_test(
            both, (col[0:1], col[1:2], col[2:3]),
            (col[3:4], col[4:5], col[5:6]), col[6:7], col[7:8])
        assert bool(ok.all())
        assert abs(float(tt[0, 0] - tt[0, 1])) <= 1e-6 * abs(t_ref[r])


@pytest.mark.parametrize("use_bw", [True, False])
def test_mixed_plain_matches_pallas(scenes, ray_sets, use_bw):
    """K4: the closest half equals the closest sweep, the any-hit half
    the occlusion verdicts, against mt_sweep_resident_mixed."""
    jsd, tsd = scenes
    rays_c, rays_s = (_pack(r) for r in ray_sets)
    rays = np.ascontiguousarray(np.concatenate([rays_c, rays_s], axis=1))
    nc = rays_c.shape[1]
    flags = (np.arange(rays.shape[1] // 256) >= nc // 256).astype(np.int32)
    jop = jsd.tri_bw if use_bw else jsd.tri_packed
    t_ref, i_ref = pallas_mt.mt_sweep_resident_mixed(
        jop, jsd.tri_tile_bounds, jsd.scene_bounds, jnp.asarray(rays),
        jnp.asarray(flags), use_bw=use_bw)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    top = tsd.tri_bw if use_bw else tsd.tri_packed
    keys, bits = sweep.ray_tile_entry_keys(tsd.tri_tile_bounds, _t(rays))
    t, i = sweep.resident_sweep_mixed(top, keys, bits, _t(rays),
                                      _t(flags))
    t, i = t.numpy(), i.numpy()
    _assert_closest(t[:nc], i[:nc], t_ref[:nc], i_ref[:nc], top.numpy(),
                    rays_c)
    occ, occ_ref = i[nc:] >= 0, i_ref[nc:] >= 0
    np.testing.assert_array_equal(occ, occ_ref)
    assert 50 < occ.sum() < (rays_s[6] <= rays_s[7]).sum() - 50


@pytest.mark.parametrize("raw", [False, True])
def test_intersect_mixed_matches_jax(scenes, ray_sets, monkeypatch, raw):
    jsd, tsd = scenes
    (c, s) = ray_sets
    monkeypatch.setattr(jax_config, "accel_mode", "pallas")
    jargs = [jnp.asarray(a) for a in c + s]
    targs = [_t(a) for a in c + s]
    ref = jax_traverse.intersect_mixed(jsd, *jargs, raw=raw)
    got = torch_traverse.intersect_mixed(tsd, *targs, raw=raw)
    n = c[0].shape[0]
    rows = tsd.tri_bw.numpy()
    rays_c = _pack(c)
    if raw:
        t_ref, i_ref, occ_ref = (np.asarray(a) for a in ref)
        t, i, occ = (a.numpy() for a in got)
        assert t.shape == t_ref.shape == (-(-n // 256) * 256,)
        _assert_closest(t[:n], i[:n], t_ref[:n], i_ref[:n], rows, rays_c)
    else:
        hit_ref, occ_ref = ref
        hit, occ = got
        i_ref = np.where(np.asarray(hit_ref.valid), np.asarray(hit_ref.tri),
                         -1)
        i = hit.tri.numpy()
        _assert_closest(hit.t.numpy(), i, np.asarray(hit_ref.t), i_ref, rows,
                        rays_c)
        same = (i >= 0) & (i == i_ref)
        for a, b in ((hit.u, hit_ref.u), (hit.v, hit_ref.v)):
            np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                       atol=1e-5)
        occ, occ_ref = occ.numpy(), np.asarray(occ_ref)
    assert occ.shape == (n,)
    np.testing.assert_array_equal(occ, occ_ref)


def test_intersect_mixed_equals_separate_queries(scenes, ray_sets):
    _, tsd = scenes
    c, s = ray_sets
    hit, occ = torch_traverse.intersect_mixed(
        tsd, *(_t(a) for a in c + s))
    ref = torch_traverse.intersect(tsd, *(_t(a) for a in c))
    occ_ref = torch_traverse.occluded(tsd, *(_t(a) for a in s))
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, occ_ref)


# ---------------------------------------------------------------------------
# K2-mxu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.living_room(32, 32, 1, detail=3),
    lambda m: m.cornell_box(16, 16, 1, sphere_subdiv=2)],
    ids=["living_room", "cornell_box"])
def test_tri_mxu_bit_equal(make):
    ref = np.asarray(make(jax_scenes).compile().tri_mxu)
    got = make(torch_scenes).compile_arrays()["tri_mxu"]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("any_hit", [False, True])
def test_mxu_plain_matches_pallas(scenes, ray_sets, any_hit):
    jsd, tsd = scenes
    rays_np = _pack(ray_sets[1] if any_hit else ray_sets[0])
    t_ref, i_ref = pallas_mt.mt_sweep_resident(
        jsd.tri_mxu, jsd.tri_tile_bounds, jsd.scene_bounds,
        jnp.asarray(rays_np), any_hit=any_hit, use_mxu=True)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t, i = (a.numpy() for a in sweep.resident_sweep_mxu_plain(
        tsd.tri_mxu, _t(rays_np), any_hit))
    hit_ref = i_ref >= 0
    assert hit_ref.sum() > 100 and (~hit_ref).sum() > 40
    if any_hit:
        assert ((i >= 0) == hit_ref).mean() > 0.999
        return
    assert (i == i_ref).mean() > 0.999
    same = (i == i_ref) & hit_ref
    assert np.max(np.abs(t[same] - t_ref[same])
                  / np.maximum(t_ref[same], 1e-3)) < 1e-4


def test_mxu_traverse_agrees_with_bw(scenes, ray_sets, monkeypatch):
    """config.USE_MXU_SWEEP sends a resident scene's queries to K2-mxu:
    the hit set of the BW sweep on >= 99.9% of rays, the same
    occlusion verdicts."""
    _, tsd = scenes
    c, s = ray_sets
    ref = torch_traverse.intersect(tsd, *(_t(a) for a in c))
    occ_ref = torch_traverse.occluded(tsd, *(_t(a) for a in s))
    monkeypatch.setattr(torch_config, "USE_MXU_SWEEP", True)
    before = sweep.resident_sweep_mxu.launches
    got = torch_traverse.intersect(tsd, *(_t(a) for a in c))
    occ = torch_traverse.occluded(tsd, *(_t(a) for a in s))
    assert sweep.resident_sweep_mxu.launches == before == 0
    assert (got.tri == ref.tri).float().mean() > 0.999
    assert (occ == occ_ref).float().mean() > 0.999
    rays = _t(_pack(c))
    keys, bits = sweep.ray_tile_entry_keys(tsd.tri_tile_bounds, rays)
    for a, b in zip(sweep.resident_sweep_mxu(tsd.tri_mxu, keys, bits, rays),
                    sweep.resident_sweep_mxu_plain(tsd.tri_mxu, rays)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):    # the 9-row soup is not the operand
        sweep.resident_sweep_mxu(tsd.tri_packed, keys, bits, rays)


# ---------------------------------------------------------------------------
# the merged wavefront step
# ---------------------------------------------------------------------------

MERGED_CASES = {
    "cornell_box": (lambda m: m.cornell_box(24, 16, 4, sphere_subdiv=2),
                    4096, 3),
    "living_room": (lambda m: m.living_room(16, 16, 2, detail=3), 4096, 0),
}


@pytest.mark.parametrize("name", sorted(MERGED_CASES))
def test_merged_equals_two_launch(name):
    """The merged step changes launches, not samples: the same image bit
    for bit and the same rays, on the Baldwin-Weber default."""
    make, n_lanes, seed = MERGED_CASES[name]
    before = sweep.resident_sweep_mixed.launches
    a, sa = torch_wf.render_wavefront(make(torch_scenes), seed=seed,
                                      n_lanes=n_lanes, device="cpu",
                                      merged=False)
    b, sb = torch_wf.render_wavefront(make(torch_scenes), seed=seed,
                                      n_lanes=n_lanes, device="cpu",
                                      merged=True)
    assert not sa["merged"] and sb["merged"]
    assert sb["rays"] == sa["rays"] and sb["steps"] == sa["steps"]
    assert np.array_equal(a, b)
    assert a.mean() > 0.05
    assert sweep.resident_sweep_mixed.launches == before == 0


def test_merged_reads_config(monkeypatch):
    scene = torch_scenes.cornell_box(16, 8, 2, sphere_subdiv=2)
    monkeypatch.setattr(torch_config, "MERGED_SWEEP", True)
    _, st = torch_wf.render_wavefront(scene, seed=1, n_lanes=4096,
                                      device="cpu")
    assert st["merged"]
    monkeypatch.setattr(torch_config, "MERGED_SWEEP", False)
    _, st = torch_wf.render_wavefront(
        torch_scenes.cornell_box(16, 8, 2, sphere_subdiv=2), seed=1,
        n_lanes=4096, device="cpu")
    assert not st["merged"]


def test_merged_unaligned_pool():
    """n_lanes not a multiple of the 256-ray tile (the carried hits are
    padded to the packed width): the image of a 4,096-lane pool, as
    tests/test_mixed_sweep.py:137 asks of the JAX package."""
    make = lambda: torch_scenes.cornell_box(16, 8, 2, sphere_subdiv=2)  # noqa
    a, sa = torch_wf.render_wavefront(make(), seed=4, n_lanes=1000,
                                      device="cpu", merged=True)
    b, sb = torch_wf.render_wavefront(make(), seed=4, n_lanes=4096,
                                      device="cpu", merged=True)
    assert sa["merged"] and sa["rays"] == sb["rays"]
    assert np.array_equal(a, b)


def test_merged_matches_jax(monkeypatch):
    """The port's merged step against nori_tpu's with
    config.MERGED_SWEEP=True, both on the Moller-Trumbore test."""
    monkeypatch.setattr(jax_config, "MERGED_SWEEP", True)
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)
    make = lambda m: m.cornell_box(24, 16, 4, sphere_subdiv=2)  # noqa
    ref, ref_st = jax_wf.render_wavefront(make(jax_scenes), seed=3,
                                          n_lanes=4096)
    img, st = torch_wf.render_wavefront(make(torch_scenes), seed=3,
                                        n_lanes=4096, device="cpu",
                                        merged=True)
    assert st["merged"]
    assert st["rays"] == ref_st["rays"] and st["steps"] == ref_st["steps"]
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.05


def test_merged_gating(monkeypatch):
    """Merged only for NEE modes on resident-layout scenes
    (wavefront.py:196-199): never for path_mats, never when streamed."""
    scene = torch_scenes.cornell_box(16, 8, 2, sphere_subdiv=2)
    assert torch_wf.merged_step(scene, MIS, True)
    assert torch_wf.merged_step(scene, EMS, True)
    assert not torch_wf.merged_step(scene, MATS, True)
    assert not torch_wf.merged_step(scene, MIS, False)
    mats = torch_scenes.cornell_box(16, 8, 2, integrator="path_mats",
                                    sphere_subdiv=2)
    _, st = torch_wf.render_wavefront(mats, seed=1, n_lanes=4096,
                                      device="cpu", merged=True)
    assert not st["merged"]
    monkeypatch.setattr(torch_scene_mod, "STREAMED_BYTES", 9 * 1024 * 4)
    big = torch_scenes.living_room(8, 8, 1, detail=3)
    assert big.compile_arrays()["tri_packed"].shape[0] == 16
    assert not torch_wf.merged_step(big, MIS, True)


def test_lane_order_changes_no_sample():
    """The coherence sort (K3 keys) only reorders lanes: the image and
    the rays equal those of an unsorted pool, bit for bit.  So K3's
    fine field, which differs from the Pallas kernel's where candidates
    at offsets >= 21 round into its float sum, cannot change a result."""
    make = lambda: torch_scenes.living_room(16, 16, 2, detail=3)  # noqa
    a, sa = torch_wf.render_wavefront(make(), seed=0, n_lanes=4096,
                                      sort_rays=True, device="cpu")
    b, sb = torch_wf.render_wavefront(make(), seed=0, n_lanes=4096,
                                      sort_rays=False, device="cpu")
    assert sa["rays"] == sb["rays"]
    assert np.array_equal(a, b)
