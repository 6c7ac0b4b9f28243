"""The path-graph pipeline (nori_tpu_torch.pathgraph) against
nori_tpu.pathgraph on the CPU.

Both sides read the same inputs: the JAX package's dump of the test
fixture of tests/test_pathgraph.py (cornell_box 32x32, 1 spp,
sphere_subdiv 1, max_depth 5, batch 1024, seed 0), its k-NN lists and
its clusters (k = 8), passed as numpy arrays.  The port's dump is traced
with the Moller-Trumbore operand (config.USE_BW_SWEEP False), whose
plain sweeps round as the JAX package's CPU scan does.

Tolerances:
  io              files byte-equal, each package loads the other's
  bsdfgraph       rtol 2e-5, atol 1e-6 max|ref|, except queries within
                  1e-6 of the 't' class's 1e-5 alignment threshold
                  (counted)
  knn, clusters   equal arrays
  aggregation     rtol 1e-4, atol 1e-5 max|ref|
  dump            integer fields equal; floats rtol 1e-4, atol 1e-5 on
                  every first vertex and on all but fewer than 1% of the
                  points (the image gate's form): after a bounce or two
                  off the faceted spheres the ULP differences of the two
                  libraries' sampling and hit rebuild have grown past
                  1e-4 (8 of 3,188 points of the fixture, at depths 2-4),
                  and on the ajax stand-in a light sample seen edge-on
                  (cos ~1e-7) moves its pdf and flips its shadow ray
                  (2 of 296 points, depth 1)
  pg images       RMSE < 1e-3, < 1% of pixels off by more than 1e-3,
                  max |diff| < 5e-3 (tests/test_torch_render.py's gate)
  analysis/merge/visual  equal outputs, visual PNGs byte-equal
"""

import io as _io

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu.accel import pallas_mt
from nori_tpu.pathgraph import aggregate as jagg
from nori_tpu.pathgraph import analysis as janalysis
from nori_tpu.pathgraph import bsdfgraph as jbg
from nori_tpu.pathgraph import cluster as jcluster
from nori_tpu.pathgraph import dump as jdump
from nori_tpu.pathgraph import grid as jgrid
from nori_tpu.pathgraph import io as jio
from nori_tpu.pathgraph import merge as jmerge
from nori_tpu.pathgraph import pg as jpg
from nori_tpu.pathgraph import visual as jvisual

from nori_tpu_torch import config as torch_config
from nori_tpu_torch import scene as torch_scene_mod
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch.bitmap import read_exr, write_exr
from nori_tpu_torch.pathgraph import aggregate as tagg
from nori_tpu_torch.pathgraph import analysis as tanalysis
from nori_tpu_torch.pathgraph import bsdfgraph as tbg
from nori_tpu_torch.pathgraph import cluster as tcluster
from nori_tpu_torch.pathgraph import dump as tdump
from nori_tpu_torch.pathgraph import grid as tgrid
from nori_tpu_torch.pathgraph import io as tio
from nori_tpu_torch.pathgraph import merge as tmerge
from nori_tpu_torch.pathgraph import pg as tpg
from nori_tpu_torch.pathgraph import visual as tvisual

from test_torch_render import ajax_scene
from torch_threads import one_torch_thread  # noqa: F401

K = 8
CPU = "cpu"
IMAGES = ("_k-8_direct.exr", "_k-8_direct_o.exr", "_Le_init.exr",
          "_k-8_full.exr", "_k-8_indirect.exr", "_k-8_indirect_pt.exr",
          "_k-8_indirect_blur.exr")


@pytest.fixture(autouse=True)
def _moller_trumbore(monkeypatch):
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)


@pytest.fixture(scope="module")
def graph():
    scene = jax_scenes.cornell_box(width=32, height=32, spp=1,
                                   sphere_subdiv=1)
    return jdump.trace_dump(scene, max_depth=5, batch=1024)


@pytest.fixture(scope="module")
def links(graph):
    """The JAX package's k-NN lists and clusters of the fixture."""
    g = graph
    pos = np.asarray(g.sps["pos"])
    dims = g.grid_dimensions()
    grid = jgrid.UniformGrid(pos, dims, g.aabb_min, g.aabb_max)
    nbr, counts = jgrid.knn(pos, grid, K)
    cid, order, offsets = jcluster.build_clusters(
        pos, dims, g.aabb_min, g.aabb_max, K)
    members, sizes = jcluster.pad_clusters(order, offsets, pad=2 * K)
    return dict(nbr=nbr, counts=counts, cid=cid, order=order,
                offsets=offsets, members=members, sizes=sizes)


def _points(g, links):
    """(JAX GraphPoints, port GraphPoints) of one dump, groupIdx set to
    the JAX clusters."""
    jgp, tgp = jbg.GraphPoints(g.sps), tbg.GraphPoints(g.sps, CPU)
    jgp.groupIdx = jnp.asarray(links["cid"].astype(np.int32))
    tgp.groupIdx = torch.as_tensor(links["cid"], dtype=torch.int32)
    return jgp, tgp


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rtol, atol_scale):
    got, ref = _host(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    atol = atol_scale * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _agg_close(got, ref):
    _close(got, ref, 1e-4, 1e-5)


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_io_files_byte_equal_and_cross_load(graph, links, tmp_path):
    for dt in ("SPOINT_DTYPE", "LPOINT_DTYPE", "CPATH_DTYPE", "AABB_DTYPE"):
        assert getattr(tio, dt) == getattr(jio, dt)
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jio.save_path_graph(a, graph)
    tio.save_path_graph(b, graph)
    jio.save_neighbors(a, links["cid"], links["offsets"][:-1])
    tio.save_neighbors(b, links["cid"], links["offsets"][:-1])
    for suffix in ("_vert.bin", "_paths.bin", "_light.bin", "_aabb.bin",
                   "_sensor.bin", "neighbors.bin", "_clusters.bin"):
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            assert fa.read() == fb.read(), suffix
    for loaded in (tio.load_path_graph(a), jio.load_path_graph(b)):
        for name in ("sps", "lps", "paths"):
            assert getattr(loaded, name).tobytes() == getattr(
                graph, name).tobytes()
        assert (loaded.xres, loaded.yres) == (graph.xres, graph.yres)
        np.testing.assert_array_equal(loaded.aabb_min, graph.aabb_min)
        np.testing.assert_array_equal(loaded.camera_matrix,
                                      graph.camera_matrix)
        assert loaded.fov == graph.fov
    for cl, off in (tio.load_neighbors(a), jio.load_neighbors(b)):
        np.testing.assert_array_equal(cl, links["cid"])
        np.testing.assert_array_equal(off, links["offsets"][:-1])
    np.testing.assert_array_equal(tio.load_path_graph(a).grid_dimensions(),
                                  graph.grid_dimensions())


# ---------------------------------------------------------------------------
# bsdfgraph
# ---------------------------------------------------------------------------

def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _near_threshold(sps, idx, wi):
    """Queries of 't' points whose alignment |<wi, dir> - 1| (float64)
    lies within 1e-6 of the 1e-5 threshold, for the reflected or the
    refracted direction.  idx: the points (...), wi: (..., 3)."""
    wo = sps["wo"][idx].astype(np.float64)
    n = sps["shN"][idx].astype(np.float64)
    eta = sps["eta"][idx, 0].astype(np.float64)
    is_t = sps["bsdf_type"][idx] == b"t"
    c = np.sum(wo * n, -1)
    refl = _unit(2.0 * c[..., None] * n - wo)
    scale = np.where(c > 0.0, 1.0 / eta, eta)
    ct2 = 1.0 - (1.0 - c * c) * scale * scale
    ct = np.sqrt(np.maximum(ct2, 0.0))
    cos_t = np.where(ct2 <= 0.0, 0.0, np.where(c > 0.0, -ct, ct))
    sel = np.where(cos_t < 0.0, 1.0 / eta, eta)
    refr = _unit(-sel[..., None] * (wo - c[..., None] * n)
                 + cos_t[..., None] * n)
    wi = wi.astype(np.float64)
    near = np.zeros(is_t.shape, bool)
    for d in (refl, refr):
        gap = np.abs(np.sum(wi * d, -1) - 1.0)
        near |= np.abs(gap - 1e-5) <= 1e-6
    return near & is_t


def _bsdf_cases(graph, links):
    """(sps, name) inputs: the fixture's dump, and the same dump with
    every 'o' point relabelled as the 'c' conductor (which no dump of
    the renderer holds) with seeded eta and k."""
    sps = graph.sps
    cond = sps.copy()
    rng = np.random.RandomState(3)
    o = cond["bsdf_type"] == b"o"
    cond["bsdf_type"][o] = b"c"
    cond["eta"][o] = rng.uniform(0.2, 2.5, (o.sum(), 3))
    cond["k"][o] = rng.uniform(0.5, 4.0, (o.sum(), 3))
    cond["roughness"][o] = rng.uniform(0.05, 0.6, o.sum())
    return {"dump": sps, "conductor": cond}


@pytest.mark.parametrize("case", ["dump", "conductor"])
def test_graph_bsdf_matches_jax(graph, links, case):
    sps = _bsdf_cases(graph, links)[case]
    n = len(sps)
    jgp, tgp = jbg.GraphPoints(sps), tbg.GraphPoints(sps, CPU)
    nbr = links["nbr"]
    own = np.arange(n)
    queries = {
        "wi": (own, sps["wi"]),
        "wi_d": (own, sps["wi_d"]),
        # the aggregation's queries: a point's BSDF at its neighbors' wi
        "neighbors' wi": (np.repeat(own[:, None], nbr.shape[1], 1),
                          sps["wi"][nbr]),
    }
    near_total = 0
    for label, (idx, wi) in queries.items():
        jsp = jgp.gather(jnp.asarray(idx))
        tsp = tgp.gather(torch.as_tensor(idx))
        near = _near_threshold(sps, idx, wi)
        near_total += int(near.sum())
        for fn in ("eval_graph_bsdf", "pdf_graph_bsdf"):
            ref = np.asarray(getattr(jbg, fn)(jsp, jnp.asarray(wi)))
            got = getattr(tbg, fn)(tsp, torch.as_tensor(wi)).numpy()
            assert got.shape == ref.shape and np.isfinite(got).all()
            tol = 2e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
            bad = np.abs(got - ref) > tol
            if bad.ndim > near.ndim:
                bad = bad.any(-1)
            assert not (bad & ~near).any(), (
                f"{case} {label} {fn}: {int((bad & ~near).sum())} queries "
                f"off the threshold differ")
    print(f"{case}: {near_total} queries near the 't' alignment threshold")


def test_delta_dielectric_alignment_matches_jax():
    """The sampler's own refractions and TIR reflections of
    tests/test_pathgraph.py's dielectric case evaluate alike."""
    rng = np.random.RandomState(11)
    n = 256
    eta = 1.5046 / 1.000277
    sps = np.zeros(n, jio.SPOINT_DTYPE)
    shn = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    wo = rng.randn(n, 3).astype(np.float32)
    wo[: n // 2, 2] = np.abs(wo[: n // 2, 2]) + 0.05
    wo[n // 2:, 2] = -np.abs(wo[n // 2:, 2]) - 0.05
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    cos_i = wo[:, 2]
    rel = np.where(cos_i > 0, 1.0 / eta, eta).astype(np.float32)
    sin2_t = (1.0 - cos_i ** 2) * rel * rel
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0)) * -np.sign(cos_i)
    wi = (-rel[:, None] * (wo - cos_i[:, None] * shn)
          + cos_t[:, None] * shn).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    tir = sin2_t >= 1.0
    wi[tir] = (2.0 * cos_i[:, None] * shn - wo)[tir]
    sps["wo"], sps["shN"], sps["geoN"], sps["wi"] = wo, shn, shn, wi
    sps["eta"], sps["diffuse"], sps["specular"] = eta, 1.0, 1.0
    sps["rrpdf"], sps["nidx"], sps["bsdf_type"] = 1.0, 1, b"t"
    jgp, tgp = jbg.GraphPoints(sps), tbg.GraphPoints(sps, CPU)
    for fn in ("eval_graph_bsdf", "pdf_graph_bsdf"):
        ref = np.asarray(getattr(jbg, fn)(jgp, jgp.wi))
        got = getattr(tbg, fn)(tgp, tgp.wi).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=1e-6 * np.abs(ref).max())
        assert ((got > 0) == (ref > 0)).all()
        assert (got.reshape(n, -1).max(-1) > 0).sum() > n // 2


# ---------------------------------------------------------------------------
# grid / cluster
# ---------------------------------------------------------------------------

def _random_points(n, seed):
    return np.random.RandomState(seed).rand(n, 3).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "dump"])
def test_knn_matches_jax(graph, case):
    if case == "random":
        pos, dims = _random_points(500, 0), np.array([8, 8, 8])
        lo, hi, k = np.zeros(3), np.ones(3), 6
    else:
        pos, dims = np.asarray(graph.sps["pos"]), graph.grid_dimensions()
        lo, hi, k = graph.aabb_min, graph.aabb_max, K
    ref_nbr, ref_cnt = jgrid.knn(pos, jgrid.UniformGrid(pos, dims, lo, hi), k)
    grid = tgrid.UniformGrid(pos, dims, lo, hi)
    nbr, cnt = tgrid.knn(pos, grid, k, device=CPU)
    np.testing.assert_array_equal(nbr.numpy(), ref_nbr)
    np.testing.assert_array_equal(cnt.numpy(), ref_cnt)
    if case == "random":
        # small chunks and a pinned cap give the same lists
        nbr2, _ = tgrid.knn(pos, grid, k, chunk=37, device=CPU)
        np.testing.assert_array_equal(nbr2.numpy(), ref_nbr)
        assert (nbr.numpy()[:, 0] == np.arange(len(pos))).all()


@pytest.mark.parametrize("case", ["random", "dump"])
def test_clusters_match_jax(graph, case):
    if case == "random":
        pos, dims = _random_points(2000, 1), np.array([12, 12, 12])
        lo, hi = np.zeros(3), np.ones(3)
    else:
        pos, dims = np.asarray(graph.sps["pos"]), graph.grid_dimensions()
        lo, hi = graph.aabb_min, graph.aabb_max
    ref = jcluster.build_clusters(pos, dims, lo, hi, K)
    got = tcluster.build_clusters(pos, dims, lo, hi, K, device=CPU)
    moved = int((got[0] != ref[0]).sum())
    print(f"{case}: {moved} points in another cluster than the JAX "
          f"package's")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for pad in (2 * K, 4):
        for a, b in zip(tcluster.pad_clusters(got[1], got[2], pad),
                        jcluster.pad_clusters(ref[1], ref[2], pad)):
            np.testing.assert_array_equal(a, b)


def test_nearest_seed_fallback_matches_jax():
    """Points far from every seed cell take the globally nearest seed."""
    rng = np.random.RandomState(5)
    seeds = rng.rand(40, 3).astype(np.float32) * 0.2
    pos = np.concatenate([rng.rand(300, 3).astype(np.float32) * 0.2,
                          0.8 + rng.rand(60, 3).astype(np.float32) * 0.2])
    sgrid = jcluster.UniformGrid(seeds, np.array([6, 6, 6]), np.zeros(3),
                                 np.ones(3))
    ref = jcluster._nearest_seed(pos, seeds, sgrid)
    got = tcluster._nearest_seed(pos, seeds, tgrid.UniformGrid(
        seeds, np.array([6, 6, 6]), np.zeros(3), np.ones(3)), CPU, chunk=128)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _block_case(name, graph, links):
    """(port result, JAX result) of one aggregation function on the
    fixture's dump, neighbors and clusters."""
    jgp, tgp = _points(graph, links)
    nbr, m, s, cid = (links["nbr"], links["members"], links["sizes"],
                      links["cid"])
    temp = np.asarray(graph.sps["eLi"]) + np.asarray(graph.sps["eLd"])
    if name == "pdf_sums_knn":
        return tagg.pdf_sums_knn(tgp, nbr), jagg.pdf_sums_knn(jgp, nbr)
    if name in ("pdf_marginal_knn", "pdf_marginal_knn_jitter"):
        jit = name.endswith("jitter")
        return (tagg.pdf_marginal_knn(tgp, nbr, jitter=jit),
                jagg.pdf_marginal_knn(jgp, nbr, jitter=jit))
    if name == "weight_norms_knn":
        return (torch.stack(tagg.weight_norms_knn(tgp, nbr)),
                np.stack(jagg.weight_norms_knn(jgp, nbr)))
    if name == "scatter_radiance_knn":
        marg = jagg.pdf_marginal_knn(jgp, nbr)
        return (tagg.scatter_radiance_knn(tgp, temp, nbr, marg),
                jagg.scatter_radiance_knn(jgp, temp, nbr, marg))
    if name == "scatter_radiance_knn_weighted":
        # each side's own weights: a deposit past max_dist weighs 0, and
        # the neighbor at max_dist sits on that edge in its own rounding
        ws, md, marg = jagg.weight_norms_knn(jgp, nbr)
        tws, tmd, tmarg = tagg.weight_norms_knn(tgp, nbr)
        return (tagg.scatter_radiance_knn(tgp, temp, nbr, tmarg,
                                          weights=(tws, tmd), chunk=100),
                jagg.scatter_radiance_knn(jgp, temp, nbr, marg,
                                          weights=(ws, md)))
    if name == "last_run":
        return tagg.last_run(tgp, temp), jagg.last_run(jgp, temp)
    if name == "marginal_cluster":
        return (tagg.marginal_cluster(tgp, m, s, cid),
                jagg.marginal_cluster(jgp, m, s, cid))
    if name in ("direct_cluster", "direct_cluster_emitter"):
        em = name.endswith("emitter")
        return (tagg.direct_cluster(tgp, graph.lps, m, s, chunk=37,
                                    include_emitter=em),
                jagg.direct_cluster(jgp, graph.lps, m, s,
                                    include_emitter=em))
    if name == "elements_mx":
        marg = jagg.marginal_cluster(jgp, m, s, cid)
        mem = jnp.asarray(m)
        e_ref = jagg._elements_block(jgp, jnp.asarray(marg), mem,
                                     jnp.asarray(s))
        mx_ref = jagg._mx_from_elements_block(e_ref, jnp.asarray(temp), mem)
        tm, tt = torch.as_tensor(m, dtype=torch.int64), torch.as_tensor(temp)
        e = tagg._elements_block(tgp, torch.as_tensor(marg), tm,
                                 torch.as_tensor(s))
        mx = tagg._mx_from_elements_block(e, tt, tm)
        mx_direct = tagg._mx_block(tgp, tt, torch.as_tensor(marg), tm,
                                   torch.as_tensor(s))
        _agg_close(mx_direct, np.asarray(mx_ref))
        return torch.cat([e.reshape(-1), mx.reshape(-1)]), np.concatenate(
            [np.asarray(e_ref).reshape(-1), np.asarray(mx_ref).reshape(-1)])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "pdf_sums_knn", "pdf_marginal_knn", "pdf_marginal_knn_jitter",
    "weight_norms_knn", "scatter_radiance_knn",
    "scatter_radiance_knn_weighted", "last_run", "marginal_cluster",
    "direct_cluster", "direct_cluster_emitter", "elements_mx"])
def test_aggregate_block_matches_jax(graph, links, name):
    got, ref = _block_case(name, graph, links)
    _agg_close(got, ref)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("mode", ["opt", "n", "t"])
def test_iterate_cluster_matches_jax(graph, links, mode):
    jgp, tgp = _points(graph, links)
    args = (graph.lps, links["members"], links["sizes"], links["cid"], 2)
    ref = jagg.iterate_cluster(jgp, *args, mode=mode)
    got = tagg.iterate_cluster(tgp, *args, mode=mode, chunk=50)
    assert len(got[0]) == len(ref[0]) == (1 if mode == "opt" else 2)
    for a, b in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]]):
        _agg_close(a, b)


def test_iterate_knn_matches_jax(graph, links):
    jgp, tgp = _points(graph, links)
    ref = jagg.iterate_knn(jgp, links["nbr"], 2)
    got = tagg.iterate_knn(tgp, links["nbr"], 2, chunk=500)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        _agg_close(a, b)


@pytest.mark.parametrize("variant", ["plain", "jitter", "weighted"])
def test_iterate_knn_scatter_matches_jax(graph, links, variant):
    jgp, tgp = _points(graph, links)
    kw = {"plain": {}, "jitter": {"jitter_last": True},
          "weighted": {"weighted": True}}[variant]
    ref = jagg.iterate_knn_scatter(jgp, links["nbr"], 2, **kw)
    got = tagg.iterate_knn_scatter(tgp, links["nbr"], 2, **kw)
    for a, b in zip(got, ref):
        _agg_close(a, b)


# ---------------------------------------------------------------------------
# dump
# ---------------------------------------------------------------------------

def _path_depths(g):
    first = g.paths["firstPathPointIdx"].astype(np.int64)
    cnt = g.paths["numOfPathPoints"].astype(np.int64)
    return np.arange(g.num_points) - np.repeat(first, cnt)


def _assert_dump_matches(got, ref):
    for name in ("xIdx", "yIdx", "firstPathPointIdx", "numOfPathPoints"):
        np.testing.assert_array_equal(got.paths[name], ref.paths[name])
    np.testing.assert_array_equal(got.paths["em"], ref.paths["em"])
    for name in ("nidx", "groupIdx", "bsdf_type"):
        np.testing.assert_array_equal(got.sps[name], ref.sps[name])
    depth = _path_depths(ref)
    off = np.zeros(ref.num_points, bool)
    for arr_g, arr_r in ((got.sps, ref.sps), (got.lps, ref.lps)):
        for name in arr_r.dtype.names:
            if arr_r[name].dtype.kind != "f":
                continue
            a, b = arr_g[name], arr_r[name]
            ok = np.isclose(a, b, rtol=1e-4, atol=1e-5)
            off |= ~ok.reshape(len(ok), -1).all(-1)
    print(f"dump: {int(off.sum())} of {ref.num_points} points off the "
          f"float tolerance, at depths {np.bincount(depth[off])}")
    assert off.sum() < 0.01 * ref.num_points
    assert not off[depth == 0].any()
    for name in ("aabb_min", "aabb_max"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-5)
    for name in ("camera_matrix", "camera2sample"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.fov, got.near_clip, got.xres, got.yres) == (
        ref.fov, ref.near_clip, ref.xres, ref.yres)


def test_dump_matches_jax(graph):
    scene = torch_scenes.cornell_box(width=32, height=32, spp=1,
                                     sphere_subdiv=1)
    got = tdump.trace_dump(scene, max_depth=5, batch=1024, device=CPU)
    _assert_dump_matches(got, graph)


def test_dump_streamed_matches_jax(monkeypatch):
    """The ajax composition at 16x16 under a lowered streamed bound: the
    port sweeps it with the streamed sweep's plain version."""
    bound = 9 * 1024 * 4   # soups over 1,024 triangles are streamed
    monkeypatch.setattr(pallas_mt, "RESIDENT_VMEM_BUDGET", bound)
    monkeypatch.setattr(torch_scene_mod, "STREAMED_BYTES", bound)
    small = dict(n_lat=32, n_lon=34)
    ref = jdump.trace_dump(
        ajax_scene(jax_scenes, 16, 16, 1, "path_mis", **small),
        max_depth=3, batch=128)
    scene = ajax_scene(torch_scenes, 16, 16, 1, "path_mis", **small)
    assert scene.compile_arrays()["tri_packed"].shape[0] == 16
    got = tdump.trace_dump(scene, max_depth=3, batch=128, device=CPU)
    assert ref.num_points > 200
    _assert_dump_matches(got, ref)


# ---------------------------------------------------------------------------
# pg end to end
# ---------------------------------------------------------------------------

def _image_gate(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3


@pytest.mark.parametrize("mode", ["opt", "n", "t", "l", "knn"])
def test_pg_matches_jax(graph, tmp_path, mode):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    for base in (a, b):
        jio.save_path_graph(base, graph)
    if mode == "l":
        # "l" loads the cluster assignment an earlier run saved
        jpg.run(a, k=K, iterations=1, mode="opt", verbose=False,
                save_dump=True)
        tpg.run(b, k=K, iterations=1, mode="opt", verbose=False,
                save_dump=True, device=CPU)
        for suffix in ("neighbors.bin", "_clusters.bin"):
            with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
                assert fa.read() == fb.read()
    jpg.run(a, k=K, iterations=2, mode=mode, verbose=False)
    times = {}
    tpg.run(b, k=K, iterations=2, mode=mode, verbose=False, device=CPU,
            times=times)
    assert "write" in times and all(t >= 0 for t in times.values())
    for suffix in IMAGES:
        _image_gate(read_exr(b + suffix), read_exr(a + suffix))
    assert read_exr(a + "_k-8_full.exr").mean() > 0.01


# ---------------------------------------------------------------------------
# analysis / merge / visual
# ---------------------------------------------------------------------------

def test_analysis_matches_jax(graph, links):
    import scipy.sparse as sp

    jgp, tgp = _points(graph, links)
    m, s = links["members"], links["sizes"]
    marg = jagg.marginal_cluster(jgp, m, s, links["cid"])
    ref = janalysis.build_propagation_matrix(jgp, m, s, marg)
    got = tanalysis.build_propagation_matrix(tgp, m, s, marg)
    for a, b in zip(got, ref):
        assert a.nnz == b.nnz and b.nnz > 0
        assert abs(a - b).max() <= 1e-5 * abs(b).max()
    A = sp.random(50, 50, density=0.1, random_state=0)
    A = sp.csr_matrix(A / (np.abs(A).sum(axis=1).max() * 1.5))
    x_t, h_t = tanalysis.jacobi_iterate(A, np.ones(50), iterations=50)
    x_j, h_j = janalysis.jacobi_iterate(A, np.ones(50), iterations=50)
    np.testing.assert_array_equal(x_t, x_j)
    assert h_t == h_j
    np.testing.assert_allclose(tanalysis.spectral_radius(ref[0]),
                               janalysis.spectral_radius(ref[0]), rtol=1e-6)
    for a, b in zip(tanalysis.cluster_size_histogram(links["offsets"]),
                    janalysis.cluster_size_histogram(links["offsets"])):
        np.testing.assert_array_equal(a, b)


def test_merge_matches_jax(tmp_path):
    imgs = [np.random.RandomState(i).rand(8, 8, 3).astype(np.float32)
            for i in range(3)]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(str(tmp_path / f"r{i}.exr"))
        write_exr(paths[-1], im, half=False)
    out_t, out_j = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    np.testing.assert_array_equal(tmerge.merge_exrs(paths, out_t),
                                  jmerge.merge_exrs(paths, out_j))
    with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
        assert ft.read() == fj.read()
    np.testing.assert_array_equal(
        tmerge.merge_glob(str(tmp_path / "r*.exr")),
        jmerge.merge_glob(str(tmp_path / "r*.exr")))
    for fn in ("rmse", "relative_mse"):
        assert getattr(tmerge, fn)(imgs[0], imgs[1]) == getattr(
            jmerge, fn)(imgs[0], imgs[1])
    assert tmerge.rmse(imgs[0], imgs[1], clamp=0.5) == jmerge.rmse(
        imgs[0], imgs[1], clamp=0.5)

    def render(spp):
        return imgs[0] + 0.5 / spp, {}

    assert tmerge.equal_rmse_spp(render, imgs[0], 0.02) == \
        jmerge.equal_rmse_spp(render, imgs[0], 0.02)


def test_visual_matches_jax(graph, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    for base in (a, b):
        jio.save_path_graph(base, graph)
    assert jvisual.main([a, "--pick", "16", "16", "--phases"]) == 0
    assert tvisual.main([b, "--pick", "16", "16", "--phases"]) == 0
    for suffix in ("_cloud.png", "_pick.png", "_phases.png"):
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            assert fa.read() == fb.read(), suffix
    frames = []
    for mod in (jvisual, tvisual):
        buf = _io.StringIO()
        mod.interactive_view(graph, out=buf)
        frames.append(buf.getvalue())
    assert frames[0] == frames[1] and "phase eLi+em" in frames[1]
