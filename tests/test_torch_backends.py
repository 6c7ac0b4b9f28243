"""The port's scan and BVH intersection backends against nori_tpu's.

`traverse.intersect_brute` ("scan") and `traverse.intersect_bvh`
("bvh", closest and any hit) on the same rays as
`nori_tpu.accel.traverse`: the same hit sets, the same triangles off
edges (every hit here: the rays start inside the scene's box in random
directions), t within rtol 1e-6.  Also: `config.resolve_accel` on every
mode, the BVH uploaded at its first walk and not before, the queries'
dispatch, and a small render under each backend against the sweeps'.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nori_tpu import config as jax_config
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu.accel import traverse as jax_traverse

from nori_tpu_torch import config
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch.accel import traverse
from nori_tpu_torch.scene import HOST_ONLY, SceneData, scene_bvh

from torch_threads import one_torch_thread  # noqa: F401

SCENES = {
    "cornell_box": lambda m: m.cornell_box(32, 24, 4, sphere_subdiv=1),
    "living_room": lambda m: m.living_room(32, 24, 1, detail=1),
}
N_RAYS = 2048
RTOL_T = 1e-6


def _rays(bbox_min, bbox_max, seed=0):
    """Rays from points in the scene's box in random directions; every
    8th with a short maxt, every 16th with an empty interval."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bbox_min), np.asarray(bbox_max)
    o = (lo + (hi - lo) * rng.random((N_RAYS, 3))).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mint = np.full(N_RAYS, 1e-4, np.float32)
    maxt = np.full(N_RAYS, 1e30, np.float32)
    maxt[::8] = 0.3
    mint[::16], maxt[::16] = 1.0, -1.0
    return o, d, mint, maxt


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    name = request.param
    jsd = SCENES[name](jax_scenes).compile()
    scene = SCENES[name](torch_scenes)
    sd = scene.compile("cpu")
    rays = _rays(jsd.bbox_min, jsd.bbox_max)
    return jsd, sd, rays


def _assert_hits_equal(ref, got):
    valid = np.asarray(ref.valid)
    assert np.array_equal(valid, got.valid.numpy())
    assert valid.sum() > N_RAYS // 2
    assert np.array_equal(np.asarray(ref.tri)[valid], got.tri.numpy()[valid])
    t_ref = np.asarray(ref.t)[valid]
    np.testing.assert_allclose(got.t.numpy()[valid], t_ref, rtol=RTOL_T)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["scan", "bvh", "bvh any hit"])
def test_backend_matches_jax(scene_pair, backend):
    jsd, sd, rays = scene_pair
    jr = [jnp.asarray(a) for a in rays]
    tr = [torch.from_numpy(a) for a in rays]
    if backend == "scan":
        ref = jax_traverse.intersect_brute(jsd, *jr)
        got = traverse.intersect_brute(sd, *tr)
    else:
        any_hit = backend == "bvh any hit"
        ref = jax_traverse.intersect_bvh(jsd, *jr, any_hit=any_hit)
        got = traverse.intersect_bvh(sd, *tr, any_hit=any_hit)
    if backend == "bvh any hit":
        # any hit: the same answers; the triangle is whichever was found
        assert np.array_equal(np.asarray(ref.valid), got.valid.numpy())
    else:
        _assert_hits_equal(ref, got)
        if backend == "bvh":
            # misses keep t = maxt, as the reference's walk leaves them
            miss = ~got.valid
            assert torch.equal(got.t[miss], torch.from_numpy(rays[3])[miss])


@pytest.mark.parametrize("mode", ["scan", "bvh"])
def test_queries_dispatch_on_accel_mode(scene_pair, monkeypatch, mode):
    """intersect, occluded and intersect_mixed under a forced backend
    equal the reference's queries under the same mode; the mixed query
    makes the two separate ones."""
    jsd, sd, rays = scene_pair
    monkeypatch.setattr(jax_config, "accel_mode", mode)
    monkeypatch.setattr(config, "accel_mode", mode)
    jr = [jnp.asarray(a) for a in rays]
    tr = [torch.from_numpy(a) for a in rays]
    _assert_hits_equal(jax_traverse.intersect(jsd, *jr),
                       traverse.intersect(sd, *tr))
    occ = traverse.occluded(sd, *tr)
    assert np.array_equal(np.asarray(jax_traverse.occluded(jsd, *jr)),
                          occ.numpy())
    half = [a[: N_RAYS // 2] for a in tr]
    other = [a[N_RAYS // 2:] for a in tr]
    hit, occ_m = traverse.intersect_mixed(sd, *half, *other)
    ref = traverse.intersect(sd, *half)
    assert all(torch.equal(a, b) for a, b in zip(hit, ref))
    assert torch.equal(occ_m, occ[N_RAYS // 2:])


@pytest.mark.parametrize("mode", ["pallas", "scan", "bvh", "auto", "kd"])
def test_resolve_accel(monkeypatch, mode):
    """Forced modes resolve to themselves in both packages; the port has
    no "auto" (the reference's picks the scan or the BVH on its CPU,
    which has no Pallas) and raises on it as on any unknown mode."""
    monkeypatch.setattr(config, "accel_mode", mode)
    if mode in ("auto", "kd"):
        with pytest.raises(ValueError, match="accel_mode"):
            config.resolve_accel()
        return
    monkeypatch.setattr(jax_config, "accel_mode", mode)
    assert config.resolve_accel() == jax_config.resolve_accel(1000) == mode


def test_bvh_uploaded_at_its_first_walk(monkeypatch):
    """Compiling under "bvh" uploads nothing; the first walk uploads the
    BVH of compile_arrays() once, and a copy made by .to() walks too."""
    monkeypatch.setattr(config, "accel_mode", "bvh")
    scene = torch_scenes.cornell_box(16, 8, 1, sphere_subdiv=1)
    arrays = scene.compile_arrays()
    sd = scene.compile("cpu")
    # less the BVH, plus the one field built on the device
    assert set(vars(sd)) == set(arrays) - set(HOST_ONLY) | {"tri_sub_boxes"}
    rays = [torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4),
            torch.full((4,), 1e30)]
    traverse.intersect(sd, *rays)
    bvh = scene_bvh(sd)
    for name, t in zip(HOST_ONLY, bvh):
        assert t.numpy().tobytes() == np.asarray(arrays[name]).tobytes()
    assert scene_bvh(sd) is bvh
    copy = sd.to("cpu")
    assert all(torch.equal(a, b) for a, b in zip(scene_bvh(copy), bvh))
    bare = SceneData(**vars(sd))
    with pytest.raises(RuntimeError, match="no BVH"):
        traverse.intersect_bvh(bare, *rays)


@pytest.mark.parametrize("mode", ["scan", "bvh"])
def test_render_under_backend_matches_sweeps(monkeypatch, mode):
    """A small path_mis render under each backend passes the exact image
    gate (RMSE < 1e-3, < 1% of pixels off by 1e-3) against the sweeps'
    render, with equal ray counts."""
    from nori_tpu_torch.wavefront import render_wavefront

    def render():
        return render_wavefront(
            torch_scenes.cornell_box(12, 10, 2, sphere_subdiv=1), seed=1,
            n_lanes=1024, device="cpu")

    img_p, st_p = render()
    monkeypatch.setattr(config, "accel_mode", mode)
    img, st = render()
    diff = np.abs(img - img_p)
    assert st["rays"] == st_p["rays"]
    assert np.sqrt(np.mean(diff ** 2)) < 1e-3
    assert np.mean(diff.max(axis=-1) > 1e-3) < 0.01
