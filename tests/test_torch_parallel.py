"""The multi-device drivers (nori_tpu_torch.parallel) and the sweep
report (nori_tpu_torch.profiling) on the CPU, against nori_tpu's.

Two ranks are two processes of a gloo group on this host (one
parallel.spawn renders every two-rank configuration: starting the
processes costs more than the renders); one rank runs in this process
with no group.  The JAX side runs on two devices of the virtual CPU
mesh (conftest.py).  Both sides sweep the Moller-Trumbore operand (the
port's config.USE_BW_SWEEP False, in every rank; the JAX package's CPU
scan path) with MERGED_SWEEP pinned False.

Gates: the sharded wavefront takes the JAX driver's steps, wide steps,
rays and rays per rank, and its image passes the gate of
test_torch_wavefront.py (RMSE < 1e-3, < 1% of pixels off by more than
1e-3, max |diff| < 5e-3).  The port's image is the same bits at one and
two ranks, with a ragged last global chunk, after a checkpoint's
resume, and as render_wavefront's with the same chunk: rank 0 splats
the ranks' chunks in q order, as one device splats its chunks.  The
batch driver takes JAX's rays and passes the same gate, and its image
is the single-device batch driver's bits, a ragged last batch included:
rank 0 splats the ranks' shares of a batch as one batch.
"""

import contextlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu import config as jax_config
from nori_tpu import parallel as jax_parallel
from nori_tpu import profiling as jax_profiling
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf

from nori_tpu_torch import config as torch_config
from nori_tpu_torch import parallel, profiling
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.integrators.path import MIS

from torch_threads import one_torch_thread  # noqa: F401

BOX = dict(width=48, height=32, spp=2, integrator="path_mis",
           sphere_subdiv=1)
TOTAL_Q = 48 * 32 * 2
LANES = 2048
#: four global chunks at one rank, two at two ranks
CHUNK = 768
#: 3,072 work items: at two ranks the second global chunk starts rank 1
#: at 3,456, past the last work item, so rank 1 is idle there
RAGGED = 1152
#: the batch driver's Cornell box: one 768-pixel batch per sample
SMALL = dict(width=32, height=24, spp=2, integrator="path_mis",
             sphere_subdiv=1)
#: 1,536 work items in batches of 1,024: in the second batch rank 1's
#: share starts at 1,536, past the last work item
RAGGED_BATCH = 1024
PINS = dict(USE_BW_SWEEP=False, MERGED_SWEEP=False)


@contextlib.contextmanager
def _pinned():
    old = ({k: getattr(torch_config, k) for k in PINS},
           jax_config.MERGED_SWEEP)
    for k, v in PINS.items():
        setattr(torch_config, k, v)
    jax_config.MERGED_SWEEP = False
    try:
        yield
    finally:
        for k, v in old[0].items():
            setattr(torch_config, k, v)
        jax_config.MERGED_SWEEP = old[1]


@pytest.fixture(autouse=True)
def _pins():
    with _pinned():
        yield


@pytest.fixture(scope="module")
def two_ranks():
    """{name: (image, stats, launches per rank)} of two gloo ranks."""
    jobs = [(torch_scenes.cornell_box, BOX, "wavefront",
             dict(n_lanes_dev=LANES, chunk_dev=CHUNK)),
            (torch_scenes.cornell_box, BOX, "wavefront",
             dict(n_lanes_dev=LANES, chunk_dev=RAGGED)),
            (torch_scenes.cornell_box, SMALL, "batch", {}),
            (torch_scenes.cornell_box, SMALL, "batch",
             dict(batch=RAGGED_BATCH))]
    out = parallel.spawn(parallel.render_jobs, 2, jobs, PINS,
                         device="cpu", timeout=300)
    return dict(zip((CHUNK, RAGGED, None, RAGGED_BATCH), out))


@pytest.fixture(scope="module")
def one_rank():
    """{chunk_dev: (image, stats)} of one rank, in this process."""
    with _pinned():
        return {c: parallel.render_sharded_wavefront(
            torch_scenes.cornell_box(**BOX), n_lanes_dev=LANES, chunk_dev=c,
            device="cpu") for c in (CHUNK, RAGGED)}


def _gate(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.05


def test_sharded_wavefront_matches_jax(two_ranks):
    ref, ref_st = jax_parallel.render_sharded_wavefront(
        jax_scenes.cornell_box(**BOX), jax_parallel.make_mesh(2),
        n_lanes_dev=LANES, chunk_dev=CHUNK)
    img, st, _ = two_ranks[CHUNK]
    for key in ("devices", "rays", "steps", "wide_steps", "rays_per_dev",
                "done"):
        assert st[key] == ref_st[key], key
    assert st["wide_steps"] < st["steps"]  # the drain shrank the pool
    _gate(img, ref)


def test_one_rank_equals_render_wavefront(one_rank):
    img, st = one_rank[CHUNK]
    ref, ref_st = torch_wf.render_wavefront(
        torch_scenes.cornell_box(**BOX), n_lanes=LANES, chunk=CHUNK,
        device="cpu")
    assert st["devices"] == 1 and st["rays"] == ref_st["rays"]
    assert np.array_equal(img, ref)


@pytest.mark.parametrize("chunk", [CHUNK, RAGGED])
def test_two_ranks_equal_one_rank(two_ranks, one_rank, chunk):
    img, st, _ = two_ranks[chunk]
    img1, st1 = one_rank[chunk]
    assert st["devices"] == 2 and st["done"]
    assert st["rays"] == st1["rays"] == sum(st["rays_per_dev"])
    assert np.array_equal(img, img1)


def test_checkpoint_resumes_bit_for_bit(tmp_path, monkeypatch, one_rank):
    """Cut after the first global chunk, then resume: the uncut image,
    under the JAX package's key string."""
    ck = str(tmp_path / "swf.ckpt")
    write = torch_wf._write_checkpoint

    class Stop(Exception):
        pass

    def write_then_stop(*args):
        write(*args)
        raise Stop()

    kw = dict(n_lanes_dev=LANES, chunk_dev=CHUNK, checkpoint_path=ck,
              device="cpu")
    monkeypatch.setattr(torch_wf, "_write_checkpoint", write_then_stop)
    with pytest.raises(Stop):
        parallel.render_sharded_wavefront(torch_scenes.cornell_box(**BOX),
                                          **kw)
    monkeypatch.setattr(torch_wf, "_write_checkpoint", write)
    with np.load(ck) as d:
        assert int(d["next_q0"]) == CHUNK
        key = str(d["key"])
    js = jax_scenes.cornell_box(**BOX)
    assert key == jax_wf._checkpoint_key(js, 2, 0, CHUNK) + ":ndev=1"
    img, st = parallel.render_sharded_wavefront(
        torch_scenes.cornell_box(**BOX), **kw)
    assert st["done"] and not os.path.exists(ck)
    assert st["rays"] == one_rank[CHUNK][1]["rays"]
    assert np.array_equal(img, one_rank[CHUNK][0])


def test_sharded_batch_matches_jax(two_ranks):
    ref, ref_st = jax_parallel.render_sharded(
        jax_scenes.cornell_box(**SMALL), jax_parallel.make_mesh(2))
    img, st, _ = two_ranks[None]
    assert st["devices"] == 2 and st["rays"] == ref_st["rays"]
    _gate(img, ref)


@pytest.mark.parametrize("batch", [None, RAGGED_BATCH])
def test_sharded_batch_equals_render(two_ranks, batch):
    """Two ranks give the single-device batch driver's image and rays at
    the same batch."""
    from nori_tpu_torch.render import render

    ref, ref_st = render(torch_scenes.cornell_box(**SMALL), batch=batch,
                         device="cpu")
    img, st, _ = two_ranks[batch]
    assert st["devices"] == 2 and st["rays"] == ref_st["rays"]
    assert np.array_equal(img, ref)


def test_refusals(monkeypatch):
    """A driver with WORLD_SIZE > 1 and no group would render the whole
    image on every rank; without CUDA it renders on the CPU only when
    asked; a rank's failure fails the launch."""
    drivers = (parallel.render_sharded_wavefront, parallel.render_sharded)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for driver in drivers:
        with pytest.raises(RuntimeError, match="no process group"):
            driver(torch_scenes.cornell_box(**SMALL), device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for driver in drivers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver(torch_scenes.cornell_box(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.kernel_report(torch_scenes.cornell_box(**SMALL))
    with pytest.raises(ValueError, match="outside torchrun"):
        parallel.make_group(device="cpu")
    with pytest.raises(RuntimeError, match="(?s)rank [01] of 2 exited "
                       "with 1.*has no NO_SUCH_SWITCH"):
        parallel.spawn(parallel.render_jobs, 2, [], dict(NO_SUCH_SWITCH=1),
                       device="cpu", timeout=120)


def test_rank_device_one_card_per_rank(monkeypatch):
    """By default rank r renders on card r; more ranks than cards, or
    nccl ranks sharing a card, are refused before any rank starts; ranks
    share a card only when given it by index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.rank_device(None, 0) == torch.device("cuda", 0)
    assert parallel.rank_device("cuda", 1) == torch.device("cuda", 1)
    assert parallel.rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert parallel.rank_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="rank 2 has no card"):
        parallel.rank_device(None, 2)
    with pytest.raises(RuntimeError, match="rank 2 has no card"):
        parallel.spawn(parallel.render_jobs, 3, [])
    with pytest.raises(ValueError, match="one card per rank"):
        parallel.spawn(parallel.render_jobs, 2, [], device="cuda:0")


def test_make_group_from_torchrun_environment(monkeypatch):
    """What torchrun sets (LOCAL_RANK, RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) is enough: the backend follows the device."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(LOCAL_RANK="0", RANK="0", WORLD_SIZE="1",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        group, rank, n, dev = parallel.make_group(device="cpu")
        assert (rank, n, dev.type) == (0, 1, "cpu")
        assert dist.get_backend(group) == "gloo"
    finally:
        dist.destroy_process_group()


def test_splat_chunk_past_the_film():
    """A chunk that starts past the film's end (a rank's share of the
    last global chunk) leaves the film unchanged."""
    scene = torch_scenes.cornell_box(48, 32, 2)
    new_film, splat_chunk, _ = torch_wf.make_dense_splat(scene, RAGGED, "cpu")
    film = splat_chunk(new_film(), torch.ones((RAGGED, 3)), 0,
                       torch.tensor(3456), TOTAL_Q)
    assert torch.equal(film, new_film())


def _room(make):
    return make.living_room(32, 32, 4, detail=1)


def test_candidate_stats_match_jax():
    """The port's counts against the JAX package's on the same rays,
    those of a 4,096-lane pool after 8 wavefront steps."""
    ts = _room(torch_scenes)
    sd = ts.compile("cpu")
    ts.integrator.preprocess(ts)
    init, step, _, _ = torch_wf.make_wavefront_stepper(
        ts, MIS, 4096, 64 * 4096, device="cpu")
    carry = init(0, 0, 64 * 4096)
    for _ in range(8):
        carry = step(sd, carry, 0)
    rays = [carry[0][k] for k in ("o", "d", "mint", "maxt")]
    got = profiling.candidate_stats(sd, *rays)
    ref = jax_profiling.candidate_stats(
        _room(jax_scenes).compile(), *(jnp.asarray(r.numpy()) for r in rays))
    assert got["rays"] == ref["rays"] == 4096
    assert got["fine_tiles"] == ref["fine_tiles"]
    # the JAX package divides in float32: the same counts, rounded
    for key in ("lane_pairs_per_ray", "union_pairs_per_ray"):
        assert np.float32(got[key]) == np.float32(ref[key]), key
    assert got["union_pairs_per_ray"] >= got["lane_pairs_per_ray"] > 0


def test_kernel_report_keys():
    rep = profiling.kernel_report(_room(torch_scenes), n_rays=4096,
                                  device="cpu")
    assert set(rep) == {
        "rays", "lane_pairs_per_ray", "union_pairs_per_ray", "fine_tiles",
        "sweep_ms", "sweep_mrays_per_sec", "pair_tests_per_sec",
        "gflops_est"}
    assert rep["rays"] == 4096
    for key, v in rep.items():
        assert np.isfinite(v) and v > 0, key
