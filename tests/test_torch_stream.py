"""The streamed-scale path of nori_tpu_torch against nori_tpu.

K5's plain version (sweep.stream_sweep_plain) is held against the
Pallas kernel `mt_sweep_streamed` in interpret mode on the living room
at detail 3, with the tile bounds grouped into STREAM_T slabs and the
operands zero-padded to 16 rows, as tests/test_accel_tpu_branches.py
does.  Then the streamed layout at small size: both packages' streamed
bounds are lowered (nori_tpu.accel.pallas_mt.RESIDENT_VMEM_BUDGET,
nori_tpu_torch.scene.STREAMED_BYTES) so small scenes compile to it.

Tolerances: hit masks equal, t within rtol 1e-6, triangle indices
equal except where two candidates' t tie within 1e-6 (the Pallas
kernel keeps the earliest visit, the port the lowest index); the
compiled arrays bit for bit; shadow answers equal.  Wavefront renders:
equal ray and step counts and the exact image gate of
tests/test_torch_wavefront.py (RMSE < 1e-3, < 1% of pixels off by more
than 1e-3, max |diff| < 5e-3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu import config
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf
from nori_tpu.accel import pallas_mt
from nori_tpu.accel import traverse as jax_traverse

from nori_tpu_torch import scene as torch_scene_mod
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.accel import sweep
from nori_tpu_torch import config as torch_config
from nori_tpu_torch.accel import traverse as torch_traverse

from torch_threads import one_torch_thread  # noqa: F401

N_CAMERA, N_BOUNCE = 256, 512
#: streamed bound for the small-size tests: soups over 1,024 padded
#: triangles take the streamed layout in both packages
SMALL_BOUND = 9 * 1024 * 4


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _make_rays(jsd, cam, seed):
    """(8, 768) packed rays: camera rays through random pixels, then
    bounce-like rays from random points in the scene bounds in random
    directions; every 17th lane idle (mint > maxt)."""
    rng = np.random.RandomState(seed)
    w, h = cam.output_size
    pos = jnp.asarray((rng.rand(N_CAMERA, 2) * [w, h]).astype(np.float32))
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


def _assert_only_ties_differ(rows, rays_np, i, i_ref, t_ref):
    """A winner other than the reference's only where both triangles
    are hit and their t tie within 1e-6 (rows: the operand's read
    rows, numpy)."""
    for r in np.nonzero((i_ref >= 0) & (i != i_ref))[0]:
        col = torch.from_numpy(rays_np[:, r:r + 1].copy())
        both = torch.from_numpy(rows[:, [i[r], i_ref[r]]].copy())
        ok, tt = sweep._pair_test(
            both, (col[0:1], col[1:2], col[2:3]),
            (col[3:4], col[4:5], col[5:6]), col[6:7], col[7:8])
        assert bool(ok.all())
        assert abs(float(tt[0, 0] - tt[0, 1])) <= 1e-6 * abs(t_ref[r])


@pytest.fixture(scope="module")
def slabbed():
    """Living room at detail 3 with STREAM_T slab bounds and 16-row
    operands (zero rows appended), plus (8, 768) rays."""
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

    ops = {True: pad16(jsd.tri_bw), False: pad16(jsd.tri_packed)}
    return ops, tb_s, _make_rays(jsd, js.camera, 11)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("use_bw", [True, False])
def test_stream_sweep_plain_matches_pallas(slabbed, use_bw, any_hit):
    ops, tb_s, rays_np = slabbed
    op = ops[use_bw]
    t_ref, i_ref = pallas_mt.mt_sweep_streamed(
        jnp.asarray(op), jnp.asarray(tb_s), jnp.asarray(rays_np),
        any_hit=any_hit, use_bw=use_bw, cull_t=0)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t, i = sweep.stream_sweep_plain(_t(op), _t(rays_np), any_hit, use_bw)
    t, i = t.numpy(), i.numpy()
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    assert hit.sum() > 100 and (~hit).sum() > 40
    if any_hit:
        return
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-6)
    _assert_only_ties_differ(op[:12] if use_bw else op[:9], rays_np, i,
                             i_ref, t_ref)


def test_stream_sweep_routes_cpu_tensors_to_plain(slabbed):
    ops, tb_s, rays_np = slabbed
    rays = _t(rays_np)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), rays)
    before = sweep.stream_sweep.launches
    for use_bw in (True, False):
        for any_hit in (False, True):
            got = sweep.stream_sweep(_t(ops[use_bw]), keys, bits, rays,
                                     any_hit, use_bw)
            ref = sweep.stream_sweep_plain(_t(ops[use_bw]), rays, any_hit,
                                           use_bw)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert sweep.stream_sweep.launches == before == 0


def test_stream_sweep_rejects_bad_inputs(slabbed):
    ops, tb_s, rays_np = slabbed
    rays = _t(rays_np)
    op = _t(ops[True])
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), rays)
    with pytest.raises(ValueError):   # 12 rows, not 16
        sweep.stream_sweep(op[:12].contiguous(), keys, bits, rays)
    with pytest.raises(ValueError):   # T not a multiple of STREAM_T
        sweep.stream_sweep(op[:, :1000].contiguous(), keys, bits, rays)
    with pytest.raises(ValueError):   # one key column short
        sweep.stream_sweep(op, keys[:, :-1].contiguous(), bits, rays)
    with pytest.raises(ValueError):   # one ray tile short
        sweep.stream_sweep(op, keys[:1].contiguous(), bits, rays)
    with pytest.raises(TypeError):
        sweep.stream_sweep(op, keys.float(), bits, rays)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_sweep_culled_plain_matches_pallas(slabbed, any_hit):
    """K5-cull: the dense plain version against the streamed Pallas
    sweep with sub-slab culling (cull_t 128, Moller-Trumbore rows):
    exact hit masks, t within rtol 1e-5."""
    ops, tb_s, rays_np = slabbed
    op = ops[False]
    t_ref, i_ref = pallas_mt.mt_sweep_streamed(
        jnp.asarray(op), jnp.asarray(tb_s), jnp.asarray(rays_np),
        any_hit=any_hit, use_bw=False, cull_t=128)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    keys, bits = sweep.ray_tile_entry_keys(_t(tb_s), _t(rays_np))
    t, i = (a.numpy() for a in sweep.stream_sweep_culled(
        _t(op), keys, bits, _t(rays_np), any_hit, cull_t=128))
    hit = i_ref >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    assert hit.sum() > 100 and (~hit).sum() > 40
    if not any_hit:
        np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    assert sweep.stream_sweep_culled.launches == 0


def test_sub_block_boxes(slabbed):
    """The per-128-triangle boxes of the MT rows, as _stream_call
    builds them (pallas_mt.py:770-780), and the granularity rule."""
    ops, _, _ = slabbed
    op = ops[False]
    got = sweep.sub_block_boxes(_t(op), 128).numpy()
    v0, p1, p2 = op[0:3], op[0:3] + op[3:6], op[0:3] + op[6:9]
    nq = op.shape[1] // 128
    lo = np.minimum(v0, np.minimum(p1, p2)).reshape(3, nq, 128).min(-1)
    hi = np.maximum(v0, np.maximum(p1, p2)).reshape(3, nq, 128).max(-1)
    np.testing.assert_array_equal(got[:, 0:3], lo.T)
    np.testing.assert_array_equal(got[:, 3:6], hi.T)
    assert [sweep.cull_sub_blocks(c) for c in (0, 128, 64, 512, 100)] == [
        1, 4, 8, 1, 1]
    keys, bits = sweep.ray_tile_entry_keys(
        _t(slabbed[1]), _t(slabbed[2]))
    with pytest.raises(ValueError):
        sweep.stream_sweep_culled(_t(op), keys, bits, _t(slabbed[2]),
                                  cull_t=512)


# ---------------------------------------------------------------------------
# the streamed layout at small size
# ---------------------------------------------------------------------------

@pytest.fixture
def small_bound(monkeypatch):
    monkeypatch.setattr(pallas_mt, "RESIDENT_VMEM_BUDGET", SMALL_BOUND)
    monkeypatch.setattr(torch_scene_mod, "STREAMED_BYTES", SMALL_BOUND)


def test_streamed_compile_bit_equal(small_bound):
    ref = jax_scenes.living_room(16, 16, 1, detail=3).compile()
    got = torch_scenes.living_room(16, 16, 1, detail=3).compile_arrays()
    assert got["tri_packed"].shape[0] == got["tri_bw"].shape[0] == 16
    T = got["tri_packed"].shape[1]
    assert got["tri_tile_bounds"].shape == (T // 512, 8)
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_key_coarsen_matches_jax(small_bound, monkeypatch):
    small = torch_scenes.living_room(16, 16, 1, detail=3).compile_arrays()
    assert torch_wf.key_coarsen(small["tri_packed"].shape[0],
                                small["tri_tile_bounds"].shape[0]) == 8
    assert torch_wf.key_coarsen(9, 404) == 4
    assert torch_wf.key_coarsen(9, 32) == 1
    jsd = jax_scenes.living_room(16, 16, 1, detail=3).compile()
    assert jax_wf.auto_key_coarsen(jsd) == 8


def test_streamed_traverse_matches_jax(small_bound, monkeypatch):
    js = jax_scenes.living_room(16, 16, 1, detail=3)
    jsd = js.compile()
    tsd = torch_scenes.living_room(16, 16, 1, detail=3).compile("cpu")
    assert torch_traverse.streamed(tsd)
    rays_np = _make_rays(jsd, js.camera, 5)
    o, d = rays_np[0:3].T.copy(), rays_np[3:6].T.copy()
    mint, maxt = rays_np[6].copy(), rays_np[7].copy()
    monkeypatch.setattr(config, "accel_mode", "pallas")
    ref = jax_traverse.intersect(jsd, *(jnp.asarray(a) for a in
                                        (o, d, mint, maxt)))
    got = torch_traverse.intersect(tsd, _t(o), _t(d), _t(mint), _t(maxt))
    hit = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), hit)
    assert hit.sum() > 100
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-6)
    tri, tri_ref = got.tri.numpy(), np.asarray(ref.tri)
    _assert_only_ties_differ(tsd.tri_bw.numpy()[:12], rays_np, tri,
                             np.where(hit, tri_ref, -1), np.asarray(ref.t))
    same = hit & (tri == tri_ref)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=1e-5)
    # shadow rays from the hits toward random points: the JAX package
    # sorts them by their own keys (_occluded_pallas_sorted)
    rng = np.random.RandomState(6)
    p = (o + np.where(hit, np.asarray(ref.t), 0.0)[:, None] * d)
    p = p.astype(np.float32)
    tgt = p + rng.randn(*p.shape).astype(np.float32)
    dv = tgt - p
    dist = np.linalg.norm(dv, axis=1).astype(np.float32)
    wo = (dv / dist[:, None]).astype(np.float32)
    smint = np.full_like(dist, 1e-4)
    smaxt = np.where(hit, dist, -1.0).astype(np.float32)
    occ_ref = np.asarray(jax_traverse.occluded(
        jsd, *(jnp.asarray(a) for a in (p, wo, smint, smaxt))))
    args = (_t(p), _t(wo), _t(smint), _t(smaxt))
    occ = torch_traverse.occluded(tsd, *args).numpy()
    np.testing.assert_array_equal(occ, occ_ref)
    assert 10 < occ.sum() < hit.sum()


def test_stream_cull_config_path_matches_jax(small_bound, monkeypatch):
    """config.STREAM_CULL_T = 128 with config.USE_BW_SWEEP False sends a
    streamed scene's queries through K5-cull (its wrapper, here on CPU
    tensors its plain version), against the JAX package's traverse with
    the same switches."""
    js = jax_scenes.living_room(16, 16, 1, detail=3)
    jsd = js.compile()
    tsd = torch_scenes.living_room(16, 16, 1, detail=3).compile("cpu")
    rays_np = _make_rays(jsd, js.camera, 7)
    o, d = rays_np[0:3].T.copy(), rays_np[3:6].T.copy()
    mint, maxt = rays_np[6].copy(), rays_np[7].copy()
    for mod in (config, torch_config):
        monkeypatch.setattr(mod, "STREAM_CULL_T", 128)
        monkeypatch.setattr(mod, "USE_BW_SWEEP", False)
    monkeypatch.setattr(config, "accel_mode", "pallas")
    calls = []
    culled = torch_traverse.stream_sweep_culled

    def spy(*a, **k):
        calls.append(k.get("cull_t"))
        return culled(*a, **k)

    monkeypatch.setattr(torch_traverse, "stream_sweep_culled", spy)
    ref = jax_traverse.intersect(jsd, *(jnp.asarray(a) for a in
                                        (o, d, mint, maxt)))
    got = torch_traverse.intersect(tsd, _t(o), _t(d), _t(mint), _t(maxt))
    hit = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    smaxt = np.where(hit, np.asarray(ref.t) * 0.5, -1.0).astype(np.float32)
    occ_ref = np.asarray(jax_traverse.occluded(
        jsd, *(jnp.asarray(a) for a in (o, d, mint, smaxt))))
    occ = torch_traverse.occluded(tsd, _t(o), _t(d), _t(mint),
                                  _t(smaxt)).numpy()
    np.testing.assert_array_equal(occ, occ_ref)
    assert calls == [128, 128]


WAVEFRONT_CASES = {
    # 8 slabs: the exact-bitmask sort
    "detail3": (lambda m: m.living_room(16, 16, 2, detail=3), 4096),
    # 101 slabs: K3 keys on slabs coarsened x8
    "detail5": (lambda m: m.living_room(8, 8, 2, detail=5), 256),
}


@pytest.mark.parametrize("name", sorted(WAVEFRONT_CASES))
def test_streamed_wavefront_matches_jax(small_bound, monkeypatch, name):
    monkeypatch.setattr(config, "MERGED_SWEEP", False)
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)
    make, n_lanes = WAVEFRONT_CASES[name]
    ref, ref_st = jax_wf.render_wavefront(make(jax_scenes), seed=0,
                                          n_lanes=n_lanes)
    scene = make(torch_scenes)
    assert scene.compile_arrays()["tri_packed"].shape[0] == 16
    img, st = torch_wf.render_wavefront(scene, seed=0, n_lanes=n_lanes,
                                        device="cpu")
    assert st["rays"] == ref_st["rays"]
    assert st["steps"] == ref_st["steps"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.05


def _plugin_scene(pkg: str, desc, integrator: str, spp: int):
    """A scene description (benchmark/scenegen.py) as `pkg`'s scene,
    built through its plugin API as benchmark/port.py builds the port's:
    meshes as MeshData with their BSDF and emitter, the perspective
    camera with its filter, the sampler and the integrator."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    PropertyList = mod("props").PropertyList
    create = mod("registry").create_instance

    def props(values):
        pl = PropertyList()
        for key, v in values.items():
            if isinstance(v, int):
                pl.set_integer(key, v)
            elif isinstance(v, float):
                pl.set_float(key, v)
            else:
                pl.set_color(key, np.asarray(v, np.float64))
        return pl

    scene = mod("scene").Scene(PropertyList())
    for m in desc.meshes:
        mesh = mod("mesh").Mesh()
        mesh.data = mod("obj_loader").MeshData(
            positions=np.asarray(m.positions, np.float32),
            normals=(None if m.normals is None
                     else np.asarray(m.normals, np.float32)),
            texcoords=None, faces=np.asarray(m.faces, np.uint32),
            name=m.name)
        mesh.add_child(create(m.bsdf["type"], props(
            {k: v for k, v in m.bsdf.items() if k != "type"})))
        if m.emitter is not None:
            mesh.add_child(create("area", props(
                {"radiance": list(m.emitter)})))
        mesh.activate()
        scene.add_child(mesh)
    c = desc.camera
    cam_pl = props({"width": c.width, "height": c.height,
                    "fov": float(c.fov), "nearClip": float(c.near),
                    "farClip": float(c.far)})
    cam_pl.set_transform("toWorld", mod("core.transform").Transform.lookat(
        c.origin, c.target, c.up))
    cam = create("perspective", cam_pl)
    cam.add_child(create(desc.rfilter["type"], props(
        {k: float(v) for k, v in desc.rfilter.items() if k != "type"})))
    cam.activate()
    scene.add_child(cam)
    scene.add_child(create("independent", props({"sampleCount": spp})))
    scene.add_child(create(integrator, PropertyList()))
    scene.activate()
    return scene


def test_streamed_cbox_scan_matches_jax(monkeypatch):
    """The benchmark's cbox_scan (the Cornell box with the ajax
    stand-in in place of its spheres) at a tiny size, both packages'
    streamed bounds lowered to 512 padded triangles: the port's
    streamed wavefront against the JAX package's, each scene built
    through its package's plugin API."""
    from benchmark import manifest as mf

    bound = 9 * 512 * 4
    monkeypatch.setattr(pallas_mt, "RESIDENT_VMEM_BUDGET", bound)
    monkeypatch.setattr(torch_scene_mod, "STREAMED_BYTES", bound)
    monkeypatch.setattr(config, "MERGED_SWEEP", False)
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)
    man = mf.load()
    desc = mf.scene_builder("cbox_scan")(
        {**mf.config(man, "cbox_scan"), "width": 24, "height": 18,
         "n_lat": 24, "n_lon": 20})
    ref, ref_st = jax_wf.render_wavefront(
        _plugin_scene("nori_tpu", desc, "path_mis", 2), seed=0,
        n_lanes=4096)
    scene = _plugin_scene("nori_tpu_torch", desc, "path_mis", 2)
    arrays = scene.compile_arrays()
    assert arrays["tri_packed"].shape[0] == 16
    assert arrays["tri_tile_bounds"].shape[0] == 2
    img, st = torch_wf.render_wavefront(scene, seed=0, n_lanes=4096,
                                        device="cpu")
    assert st["rays"] == ref_st["rays"]
    assert st["steps"] == ref_st["steps"]
    assert img.shape == ref.shape == (18, 24, 3) and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.05
