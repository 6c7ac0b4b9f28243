"""The slice end to end: nori_tpu_torch's persistent-wavefront path_mis
render on the CPU against nori_tpu's.

Both sides run the Moller-Trumbore test (the port's
config.USE_BW_SWEEP False; the JAX package's CPU scan path) with
config.MERGED_SWEEP pinned False, at seed 0 with 4,096 lanes.  The living room (32 tiles) takes the
kernel-key coherence sort, the Cornell box (8 tiles, sort forced on)
the exact-bitmask sort.

Gates: equal ray and step counts (no sample's value depends on lane
order, so the sets of traced rays are the same); the exact image gate
of scripts/rmse_gate.py:110 (RMSE < 1e-3 and < 1% of pixels off by
more than 1e-3); and max |diff| < 5e-3 (observed 4.6e-4 on the living
room, 1.7e-6 on the Cornell box: float32 rounding of the two
libraries' transcendentals can bend a bounce direction by an ULP).
One init + step is compared field by field after ordering lanes by
work item: q, depth and active equal, floats within 1e-5 (rtol and
atol), with two stated exceptions where the math amplifies a few-ULP
difference: the bounce direction d within atol 1e-4 (refraction near
the critical angle takes sqrt(1 - sin^2); observed 2.7e-5 on a unit
vector) and prev_pdf within rtol 1e-4 (the sampled microfacet pdf
goes through exp of the Beckmann exponent; observed 6.8e-5, see
test_torch_core).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nori_tpu import config
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf
from nori_tpu.integrators.path import MIS

from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch import config as torch_config
from nori_tpu_torch.accel import traverse as torch_traverse

from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "living_room": (lambda m: m.living_room(16, 16, 2, detail=3), None),
    "cornell_box": (lambda m: m.cornell_box(16, 16, 2, sphere_subdiv=2),
                    True),
}
N_LANES = 4096


@pytest.fixture(autouse=True)
def _unmerged(monkeypatch):
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)
    old = config.MERGED_SWEEP
    config.MERGED_SWEEP = False
    yield
    config.MERGED_SWEEP = old


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_matches_jax(name):
    make, sort_rays = CASES[name]
    ref, ref_st = jax_wf.render_wavefront(
        make(jax_scenes), seed=0, n_lanes=N_LANES, sort_rays=sort_rays)
    img, st = torch_wf.render_wavefront(
        make(torch_scenes), seed=0, n_lanes=N_LANES, sort_rays=sort_rays,
        device="cpu")
    assert st["rays"] == ref_st["rays"]
    assert st["steps"] == ref_st["steps"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.05


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_step_matches_jax(name):
    make, sort_rays = CASES[name]
    js, ts = make(jax_scenes), make(torch_scenes)
    spp = js.sampler.sample_count
    w, h = js.camera.output_size
    total = w * h * spp
    chunk = total
    jinit, jstep, _, _ = jax_wf.make_wavefront_stepper(
        js, MIS, N_LANES, chunk, sort_rays=sort_rays, merged=False)
    tinit, tstep, _, _ = torch_wf.make_wavefront_stepper(
        ts, MIS, N_LANES, chunk, sort_rays=sort_rays, device="cpu")
    jsd, tsd = js.compile(), ts.compile("cpu")
    jc = jinit(jnp.uint32(0), jnp.uint32(0), jnp.uint32(total))
    tc = tinit(0, 0, total)
    jc = jstep(jsd, jc, jnp.uint32(0))
    tc = tstep(tsd, tc, 0)
    jst = {k: np.asarray(v) for k, v in jc[0].items()}
    tst = {k: v.numpy() for k, v in tc[0].items()}
    jo, to = np.argsort(jst["q"]), np.argsort(tst["q"])
    for k in ("q", "depth", "active", "spec"):
        np.testing.assert_array_equal(tst[k][to], jst[k][jo], err_msg=k)
    for k in ("o", "d", "mint", "maxt", "beta", "L", "prev_pdf"):
        rtol = 1e-4 if k == "prev_pdf" else 1e-5
        atol = 1e-4 if k == "d" else 1e-5
        np.testing.assert_allclose(tst[k][to], jst[k][jo], rtol=rtol,
                                   atol=atol, equal_nan=True, err_msg=k)
    # next work item, record cursor and ray count
    for a, b in zip(tc[1:2] + tc[3:5], jc[1:2] + jc[3:5]):
        assert int(a) == int(b)
    # the flushed records: same samples, same radiance
    n = int(tc[3])
    jr, tr = np.asarray(jc[2])[:n], tc[2].numpy()[:n]
    jq, tq = jr[:, 0].view(np.uint32), tr[:, 0].view(np.uint32)
    np.testing.assert_array_equal(np.sort(tq), np.sort(jq))
    np.testing.assert_allclose(tr[np.argsort(tq), 1:], jr[np.argsort(jq), 1:],
                               rtol=1e-5, atol=1e-5)
