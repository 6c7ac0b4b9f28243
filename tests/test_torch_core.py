"""nori_tpu_torch core math against nori_tpu: the counter-based RNG
(bit-exact), warps, BSDF eval/pdf/sample and camera rays.

Float tolerance, both sides float32: at least 99% of the elements
agree within rtol 1e-6 (atol 1e-6), and every element within rtol 1e-3
(atol 1e-5).  The two libraries round transcendentals (exp, log, sin,
cos) and pow differently by a few ULP; the elements beyond 1e-6 are
ill-conditioned points that amplify those ULP (1 - |d|^2 near the
hemisphere rim, exp of large Beckmann exponents).  Observed: the worst
case is the sampled microfacet pdf, 99.78% within 1e-6 and at most
8e-5 relative; sampled directions reach 1.2e-4 relative only on
near-zero components.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu.core import rng as jrng
from nori_tpu.core import transform as jtransform
from nori_tpu import bsdf as jbsdf, warp as jwarp
from nori_tpu.scenes_builtin import living_room as jax_living_room

from nori_tpu_torch.core import rng as trng
from nori_tpu_torch.core import transform as ttransform
from nori_tpu_torch import bsdf as tbsdf, warp as twarp
from nori_tpu_torch.scenes_builtin import living_room as torch_living_room


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    tight = np.isclose(got, ref, rtol=1e-6, atol=1e-6)
    assert tight.mean() >= 0.99, (what, tight.mean())
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5,
                               err_msg=what)


@pytest.fixture(scope="module")
def ids():
    rng = np.random.RandomState(0)
    lanes = np.concatenate([
        np.arange(1 << 19, dtype=np.uint64),
        rng.randint(0, 1 << 32, size=(1 << 19) + 1000, dtype=np.uint64),
        np.asarray([2**31 - 1, 2**31, 2**32 - 1], np.uint64),
    ]).astype(np.uint32)
    return lanes


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_rng_bit_exact(ids, seed):
    assert ids.size >= 1_000_000
    stream = (np.arange(ids.size) % 97).astype(np.uint32)
    lanes_t = torch.from_numpy(ids.astype(np.int64))
    stream_t = torch.from_numpy(stream.astype(np.int64))
    ref_h = np.asarray(jrng.hash_combine(seed, jnp.asarray(ids),
                                         jnp.asarray(stream)))
    got_h = trng.hash_combine(seed, lanes_t, stream_t).numpy()
    np.testing.assert_array_equal(got_h.astype(np.uint32), ref_h)
    assert got_h.min() >= 0 and got_h.max() < 2**32
    ref_u = np.asarray(jrng.uniform(seed, jnp.asarray(ids), 5))
    got_u = trng.uniform(seed, lanes_t, 5).numpy()
    assert got_u.tobytes() == ref_u.tobytes()
    ref_u2 = np.asarray(jrng.uniform2(seed, jnp.asarray(ids), 0xF000))
    got_u2 = trng.uniform2(seed, lanes_t, 0xF000).numpy()
    assert got_u2.tobytes() == ref_u2.tobytes()


@pytest.mark.parametrize("name", sorted(twarp.WARPS))
def test_warps(name):
    jfn, jpdf, _, takes_alpha = jwarp.WARPS[name]
    tfn, tpdf, _, _ = twarp.WARPS[name]
    rng = np.random.RandomState(1)
    s = rng.rand(4096, 2).astype(np.float32)
    args = (0.3,) if takes_alpha else ()
    ref = np.asarray(jfn(jnp.asarray(s), *args))
    got = tfn(torch.from_numpy(s), *args).numpy()
    _close(got, ref, name)
    _close(tpdf(torch.from_numpy(ref.copy()), *args).numpy(),
           np.asarray(jpdf(jnp.asarray(ref), *args)), name + " pdf")


def _unit(rng, n):
    v = rng.randn(n, 3).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def bsdf_inputs():
    rng = np.random.RandomState(2)
    n = 8192
    p = dict(
        type=rng.randint(0, 4, n).astype(np.int32),
        albedo=rng.rand(n, 3).astype(np.float32),
        alpha=(0.05 + 0.5 * rng.rand(n)).astype(np.float32),
        int_ior=np.full(n, 1.5046, np.float32),
        ext_ior=np.full(n, 1.000277, np.float32),
        ks=(0.6 * rng.rand(n)).astype(np.float32),
    )
    wi, wo = _unit(rng, n), _unit(rng, n)
    u_lobe = rng.rand(n).astype(np.float32)
    u2 = rng.rand(n, 2).astype(np.float32)
    jp = jbsdf.BSDFParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tbsdf.BSDFParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    return jp, tp, wi, wo, u_lobe, u2


def test_eval_pdf_bsdf(bsdf_inputs):
    jp, tp, wi, wo, _, _ = bsdf_inputs
    _close(tbsdf.eval_bsdf(tp, torch.from_numpy(wi), torch.from_numpy(wo)),
           jbsdf.eval_bsdf(jp, jnp.asarray(wi), jnp.asarray(wo)), "eval")
    _close(tbsdf.pdf_bsdf(tp, torch.from_numpy(wi), torch.from_numpy(wo)),
           jbsdf.pdf_bsdf(jp, jnp.asarray(wi), jnp.asarray(wo)), "pdf")


def test_sample_bsdf(bsdf_inputs):
    jp, tp, wi, _, u_lobe, u2 = bsdf_inputs
    ref = jbsdf.sample_bsdf(jp, jnp.asarray(wi), jnp.asarray(u_lobe),
                            jnp.asarray(u2))
    got = tbsdf.sample_bsdf(tp, torch.from_numpy(wi),
                            torch.from_numpy(u_lobe), torch.from_numpy(u2))
    for f in ("wo", "weight", "pdf", "eta"):
        _close(getattr(got, f), getattr(ref, f), f)
    np.testing.assert_array_equal(got.measure.numpy(),
                                  np.asarray(ref.measure))


def test_camera_rays():
    jcam = jax_living_room(64, 36, 1, detail=3).camera
    tcam = torch_living_room(64, 36, 1, detail=3).camera
    rng = np.random.RandomState(4)
    pos = (rng.rand(4096, 2) * [64, 36]).astype(np.float32)
    ref = type(jcam).sample_rays(jcam.ray_params(), jnp.asarray(pos))
    got = type(tcam).sample_rays(tcam.ray_params("cpu"),
                                 torch.from_numpy(pos))
    for name, g, r in zip(("o", "d", "mint", "maxt"), got, ref):
        _close(g, r, name)


def test_transform_apply():
    rng = np.random.RandomState(5)
    m = (jtransform.Transform.lookat([0.3, 1.5, 2.0], [-0.3, 0.9, -1.0],
                                     [0, 1, 0])
         * jtransform.Transform.perspective(55.0, 1e-4, 1e4))
    mj, ij = jnp.asarray(m.m, jnp.float32), jnp.asarray(m.inv, jnp.float32)
    mt, it = torch.from_numpy(m.m.astype(np.float32)), torch.from_numpy(
        m.inv.astype(np.float32))
    p = rng.randn(1024, 3).astype(np.float32)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    _close(ttransform.apply_point(mt, pt), jtransform.apply_point_jnp(mj, pj),
           "point")
    _close(ttransform.apply_vector(mt, pt),
           jtransform.apply_vector_jnp(mj, pj), "vector")
    _close(ttransform.apply_normal(it, pt),
           jtransform.apply_normal_jnp(ij, pj), "normal")
