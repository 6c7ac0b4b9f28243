"""The decompositions of the two key kernels (csrc/entry_min.cu K1,
csrc/lane_keys.cu K3), emulated in plain torch and numpy on the CPU and
held bit-equal to their plain versions (sweep.entry_min_plain,
sweep.lane_keys_plain) and, through them, to the JAX package's Pallas
kernels run in interpret mode.

K1: the grid's chunks of 256 boxes, the box around each 16 or 32
consecutive boxes (the last group takes the remainder), the per-ray
gate, the minima per box of each run of lanes, the clamp taken after the
minimum, the fold of the runs' and warps' minima on the float's int
bits, and the packed-key store.  K3: the coarse bit staged with each box
and the gate per warp of 32 lanes on groups of 8 or 16 boxes.
Everything is exact: no tolerance anywhere, except K3's fine field against the Pallas kernel on lanes with a candidate at
offset >= 21 (its float sum rounds there, tests/test_torch_sweep.py).

Also here: the tests of three repairs (config.SORT_KEY_COARSEN, the BVH
arrays that stay on the host, render_wavefront's stats["done"]).
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu.accel import pallas_mt

from nori_tpu_torch import config as torch_config
from nori_tpu_torch import cuda_build
from nori_tpu_torch import scene as torch_scene_mod
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.accel import sweep

from torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.abspath(sweep.__file__)), "..",
                    "csrc")
INF = float("inf")
INF_BITS = 0x7F800000
N_RAYS = 768  # three ray tiles; the second one idle


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def make_boxes(n_tt: int, seed: int = 0) -> np.ndarray:
    """(n_tt, 8) boxes whose neighbours are close in space, as tiles in
    BVH order are: centres on a random walk, sides of 0.2 to 1.2, every
    ninth box flat in one axis."""
    rng = np.random.RandomState(seed)
    centre = np.cumsum(rng.randn(n_tt, 3) * 0.6, axis=0)
    half = 0.1 + 0.5 * rng.rand(n_tt, 3)
    half[::9, rng.randint(3)] = 0.0
    tb = np.zeros((n_tt, 8), np.float32)
    tb[:, 0:3] = centre - half
    tb[:, 3:6] = centre + half
    return tb


def make_rays(tb: np.ndarray, seed: int = 1) -> np.ndarray:
    """(8, N_RAYS) packed rays around the boxes: random origins and
    directions; every fifth ray starts at a box's centre; every seventh
    is parallel to an axis (zero and negative-zero components, which
    safe_inv turns into +-1e20); every eleventh has a short interval;
    every 17th lane and the whole second ray tile are idle."""
    rng = np.random.RandomState(seed)
    n = N_RAYS
    lo, hi = tb[:, 0:3].min(0), tb[:, 3:6].max(0)
    o = (lo + rng.rand(n, 3) * (hi - lo)).astype(np.float32)
    pick = rng.randint(tb.shape[0], size=n)
    inside = (tb[pick, 0:3] + tb[pick, 3:6]) / 2
    o[::5] = inside[::5]
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axis = np.eye(3, dtype=np.float32)[rng.randint(3, size=n)]
    axis *= np.where(rng.rand(n, 1) < 0.5, -1.0, 1.0).astype(np.float32)
    d[::7] = axis[::7]          # -1 * 0 leaves negative zeros
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    maxt[::11] = 0.5
    mint[::17], maxt[::17] = 1.0, -1.0
    mint[256:512], maxt[256:512] = 1.0, -1.0
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, mint[None], maxt[None]]).astype(np.float32))


def _slab_all(tb, rays):
    """(candidate & live (N, n_tt) bool, tn (N, n_tt)) of every ray
    against every row of tb, as the plain versions compute them."""
    cand, tn = sweep._slab(tb[:, 0:3], tb[:, 3:6], rays[0:3].T[:, None, :],
                           sweep._safe_inv(rays[3:6].T)[:, None, :],
                           rays[6][:, None], rays[7][:, None])
    return cand & (rays[6] <= rays[7])[:, None], tn


def group_rows(tb, g: int):
    """The boxes around each g consecutive rows of tb, the last group
    taking the remainder, as the kernels fold them: lanes past the last
    box hold an empty box (+inf, -inf)."""
    n_g = -(-tb.shape[0] // g)
    lo = torch.full((n_g * g, 3), INF)
    hi = torch.full((n_g * g, 3), -INF)
    lo[:tb.shape[0]], hi[:tb.shape[0]] = tb[:, 0:3], tb[:, 3:6]
    out = torch.zeros((n_g, 8))
    out[:, 0:3] = lo.reshape(n_g, g, 3).amin(1)
    out[:, 3:6] = hi.reshape(n_g, g, 3).amax(1)
    return out


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def emulate_entry_min(tb, rays, idx_bits=None, group=sweep.KEY_GROUP):
    """csrc/entry_min.cu step by step; returns ((n_rt, n_tt) int32: the
    entry distances' bits, or the packed keys with idx_bits; the ray-box
    tests done).  group 0 is the dense form: every live ray enters every
    group of 32."""
    n_tt, n = tb.shape[0], rays.shape[1]
    n_rt, G = n // sweep.TILE_N, group or 32
    out = torch.empty((n_rt, n_tt), dtype=torch.int32)
    live = (rays[6] <= rays[7])[:, None]
    tests = 0
    for j0 in range(0, n_tt, sweep.TILE_N):         # blockIdx.y
        chunk = tb[j0:j0 + sweep.TILE_N]
        m = chunk.shape[0]
        cand, tn = _slab_all(chunk, rays)
        if group:
            enters, _ = _slab_all(group_rows(chunk, G), rays)
            tests += enters.shape[1] * n
        else:
            enters = live.expand(n, -(-m // G))
        tests += G * int(enters.sum())
        tested = enters.repeat_interleave(G, dim=1)[:, :m]
        # the gate drops no candidate
        assert not bool((cand & ~tested).any())
        # lane = box: the minimum over the entering rays of each run of G
        # lanes of a warp (32 / G rays a turn, each run its own rays)
        val = torch.where(cand & tested, tn, INF)
        best = val.reshape(n_rt, sweep.TILE_N // G, G, m).amin(2)
        # clamp0 once per fold, then atomicMin on the int bits (lanes
        # whose best is +inf leave the slot at INF_BITS)
        bits = torch.where(best > 0, best, 0.0).view(torch.int32)
        folded = torch.minimum(bits.amin(1), torch.tensor(INF_BITS,
                                                          dtype=torch.int32))
        if idx_bits is not None:
            mask = (1 << idx_bits) - 1
            folded = (folded & ~mask) | torch.arange(j0, j0 + m,
                                                     dtype=torch.int32)
        out[:, j0:j0 + m] = folded
    return out, tests


@pytest.mark.parametrize("group", [0, 16, 32])
@pytest.mark.parametrize("n_tt", [1, 101, 404, 1058])
def test_entry_min_split_equals_plain(n_tt, group):
    tb, rays = _t(make_boxes(n_tt)), _t(make_rays(make_boxes(n_tt)))
    ref = sweep.entry_min_plain(tb, rays)
    got, tests = emulate_entry_min(tb, rays, group=group)
    assert torch.equal(got, ref.view(torch.int32))
    # the idle ray tile enters nothing; the others find candidates
    assert bool(torch.isinf(ref[1]).all())
    assert n_tt == 1 or bool(torch.isfinite(ref[0]).any())
    if group and n_tt >= 404:
        assert tests < 0.6 * rays.shape[1] * n_tt


@pytest.mark.parametrize("n_tt", [101, 404])
def test_entry_min_split_equals_pallas(n_tt):
    tb, rays = make_boxes(n_tt, 3), make_rays(make_boxes(n_tt, 3), 4)
    ref = np.asarray(pallas_mt._entry_min_pallas(
        jnp.asarray(tb), jnp.asarray(rays), pallas_mt.TILE_N))
    got, _ = emulate_entry_min(_t(tb), _t(rays))
    assert got.numpy().tobytes() == ref[:, :n_tt].tobytes()


@pytest.mark.parametrize("n_tt", [1, 101, 404, 1058])
def test_packed_key_store_equals_entry_keys(n_tt):
    """The kernel's (bits & ~mask) | box store, chunk by chunk, is the
    expression ray_tile_entry_keys sorts."""
    tb, rays = _t(make_boxes(n_tt, 5)), _t(make_rays(make_boxes(n_tt, 5), 6))
    bits = max(1, (n_tt - 1).bit_length())
    got, _ = emulate_entry_min(tb, rays, idx_bits=bits)
    entry = sweep.entry_min_plain(tb, rays).view(torch.int32)
    idx = torch.arange(n_tt, dtype=torch.int32)
    assert torch.equal(got, (entry & ~((1 << bits) - 1)) | idx[None, :])
    assert torch.equal(got, sweep.entry_min(tb, rays, idx_bits=bits))
    keys, key_bits = sweep.ray_tile_entry_keys(tb, rays)
    assert key_bits == bits
    assert torch.equal(keys, torch.sort(got, dim=1).values)


def test_entry_keys_equal_pallas_on_404_tiles():
    tb, rays = make_boxes(404, 7), make_rays(make_boxes(404, 7), 8)
    ref, ref_bits = pallas_mt.ray_tile_entry_keys(
        jnp.asarray(tb), jnp.asarray(rays), cap=None)
    got, bits = sweep.ray_tile_entry_keys(_t(tb), _t(rays))
    assert bits == ref_bits
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_entry_min_wrapper_arguments():
    tb, rays = _t(make_boxes(40)), _t(make_rays(make_boxes(40)))
    with pytest.raises(ValueError):
        sweep.entry_min(tb, rays, idx_bits=0)
    with pytest.raises(ValueError):
        sweep.entry_min(tb[:, :7].contiguous(), rays)
    # rows that do not start on 16 bytes are refused, not misread
    shifted = torch.zeros(41 * 8 + 1)[1:].view(41, 8)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError):
        sweep.entry_min(shifted, rays)
    with pytest.raises(ValueError):
        sweep.lane_keys(shifted, rays)
    assert torch.equal(sweep.entry_min(tb, rays),
                       sweep.entry_min_plain(tb, rays))


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [4, 8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_of_a_box_is_candidate_of_its_group(g, seed):
    """In float32, as computed: a ray for which a box is a candidate
    finds the box around that box's group a candidate, and the group's
    entry distance does not exceed the box's."""
    rng = np.random.RandomState(100 + seed)
    n_tt = 37 * g + 3
    tb_np = make_boxes(n_tt, seed)
    # some boxes huge, some far away, some tiny
    tb_np[::13, 3:6] += 1e6 * rng.rand(len(tb_np[::13]), 3).astype(np.float32)
    tb_np[5::31] *= np.float32(1e-3)
    tb, rays = _t(tb_np), _t(make_rays(tb_np, seed))
    cand, tn = _slab_all(tb, rays)
    enters, tn_g = _slab_all(group_rows(tb, g), rays)
    of_box = torch.arange(n_tt) // g
    assert cand.any() and not enters.all()
    assert not bool((cand & ~enters[:, of_box]).any())
    assert bool((tn_g[:, of_box] <= tn)[cand].all())


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def lane_chunk() -> int:
    src = open(os.path.join(CSRC, "lane_keys.cu")).read()
    return int(re.search(r"#define LANE_CHUNK (\d+)", src).group(1))


def emulate_lane_keys(tb, rays, group: int):
    """csrc/lane_keys.cu step by step; returns (key1, key2, the ray-box
    tests done)."""
    n_tt, n = tb.shape[0], rays.shape[1]
    n_tt_pad = -(-n_tt // 128) * 128
    gsz = -(-n_tt_pad // 30)
    cand = _slab_all(tb, rays)[0].numpy()
    live = (rays[6] <= rays[7]).numpy()
    warp_live = np.repeat(live.reshape(-1, 32).any(1), 32)
    # staged with each box: its coarse bit
    cbit = (1 << np.maximum(29 - np.arange(n_tt) // gsz, 0)).astype(np.uint32)
    first = np.full(n, -1, np.int64)
    fine = np.zeros(n, np.uint32)
    coarse = np.zeros(n, np.uint32)
    tests = 0

    def test(on, j):
        c = cand[:, j] & on
        later = c & (first >= 0) & (j - first <= 20)
        fine[:] |= np.where(later, 1 << np.clip(20 - (j - first), 0, 20),
                            0).astype(np.uint32)
        first[:] = np.where(c & (first < 0), j, first)
        coarse[:] |= np.where(c, cbit[j], 0).astype(np.uint32)

    chunk = lane_chunk()
    for j0 in range(0, n_tt, chunk):
        m = min(chunk, n_tt - j0)
        if not group:
            for jj in range(m):
                test(warp_live, j0 + jj)
            tests += m * int(warp_live.sum())
            continue
        boxes = group_rows(tb[j0:j0 + m], group)
        enters = _slab_all(boxes, rays)[0].numpy()
        for gi, g0 in enumerate(range(0, m, group)):
            # a warp tests a group's boxes if one of its lanes enters
            go = np.repeat(enters[:, gi].reshape(-1, 32).any(1), 32)
            for c in range(min(group, m - g0)):
                test(go, j0 + g0 + c)
            tests += int(warp_live.sum()) + min(group, m - g0) * int(go.sum())
    f1 = np.where(first < 0, n_tt_pad, first)
    key1 = (np.minimum(f1, 1023) << 20) | fine
    return key1.astype(np.int32), coarse.astype(np.int32), tests


@pytest.mark.parametrize("group", [0, 8, 16])
@pytest.mark.parametrize("n_tt", [1, 101, 404, 1058])
def test_lane_keys_split_equals_plain(n_tt, group):
    tb, rays = _t(make_boxes(n_tt, 9)), _t(make_rays(make_boxes(n_tt, 9), 10))
    p1, p2 = (k.numpy() for k in sweep.lane_keys_plain(tb, rays))
    k1, k2, tests = emulate_lane_keys(tb, rays, group)
    np.testing.assert_array_equal(k1, p1)
    np.testing.assert_array_equal(k2, p2)
    # idle lanes: first = n_tt_pad (capped), no masks
    idle = (rays[6] > rays[7]).numpy()
    assert (k1[idle] == min(-(-n_tt // 128) * 128, 1023) << 20).all()
    assert (k2[idle] == 0).all()
    if n_tt > 1:
        assert (k1[~idle] & 0xFFFFF).any() and k2[~idle].any()
    if group and n_tt >= 404:
        assert tests < 0.8 * 512 * n_tt


@pytest.mark.parametrize("n_tt", [101, 1058])
def test_lane_keys_split_equals_pallas(n_tt):
    tb, rays = make_boxes(n_tt, 11), make_rays(make_boxes(n_tt, 11), 12)
    r1, r2 = (np.asarray(k) for k in pallas_mt._lane_keys_impl(
        jnp.asarray(tb), jnp.asarray(rays)))
    k1, k2, _ = emulate_lane_keys(_t(tb), _t(rays), sweep.lane_group(n_tt))
    np.testing.assert_array_equal(k2, r2)
    np.testing.assert_array_equal(k1 >> 20, r1 >> 20)
    # the fine field differs only where candidates at offsets >= 21
    # round into the reference's float sum
    cand = _slab_all(_t(tb), _t(rays))[0].numpy()
    idx = np.arange(n_tt)[None, :]
    first = np.where(cand, idx, n_tt).min(1)[:, None]
    far = (cand & (idx - first >= 21)).any(1)
    assert ((k1 & 0xFFFFF) == (r1 & 0xFFFFF))[~far].all()
    assert (~far).sum() > 100


def test_lane_group_rule():
    assert sweep.lane_group(1) == 0 and sweep.lane_group(15) == 0
    assert sweep.lane_group(16) == sweep.lane_group(101) == sweep.LANE_GROUP
    assert sweep.lane_group(133) == sweep.LANE_GROUP
    assert sweep.lane_group(1058) == 2 * sweep.LANE_GROUP


def test_key_kernel_constants_match_sources():
    """The wrappers' constants are the sources', the staged chunk holds
    whole groups, and the ctypes signatures have the C entry points'
    argument counts."""
    common = open(os.path.join(CSRC, "common.cuh")).read()
    for name in ("KEY_GROUP", "LANE_GROUP", "TILE_N"):
        m = re.search(rf"#define {name} (\d+)", common)
        assert int(m.group(1)) == getattr(sweep, name), name
    assert 32 % sweep.KEY_GROUP == 0 and sweep.TILE_N % 32 == 0
    assert lane_chunk() % (2 * sweep.LANE_GROUP) == 0

    class Lib:
        pass

    lib = Lib()
    for fn in ("entry_min_launch", "resident_sweep_launch",
               "lane_keys_launch", "stream_sweep_launch", "mt_sweep_launch"):
        setattr(lib, fn, Lib())
    cuda_build._declare(lib)
    for fn, cu in (("entry_min_launch", "entry_min.cu"),
                   ("lane_keys_launch", "lane_keys.cu")):
        src = open(os.path.join(CSRC, cu)).read()
        args = re.search(rf'extern "C" int {fn}\((.*?)\)', src, re.S).group(1)
        assert len(getattr(lib, fn).argtypes) == args.count(",") + 1, fn


# ---------------------------------------------------------------------------
# the three repairs
# ---------------------------------------------------------------------------

def test_sort_key_coarsen_pin_changes_no_sample(monkeypatch):
    """config.SORT_KEY_COARSEN pins the grouping of the boxes K3 keys on;
    the factor reaches _coarsen_bounds once per stepper, not once per
    step, and changes lane order only."""
    calls = []
    real = torch_wf._coarsen_bounds

    def spy(kb, c):
        calls.append(c)
        return real(kb, c)

    monkeypatch.setattr(torch_wf, "_coarsen_bounds", spy)
    images, steps = {}, {}
    for pin in (None, 2, 4.7):
        monkeypatch.setattr(torch_config, "SORT_KEY_COARSEN", pin)
        before = len(calls)
        images[pin], st = torch_wf.render_wavefront(
            torch_scenes.living_room(16, 16, 2, detail=3), seed=0,
            n_lanes=4096, device="cpu")
        steps[pin] = (st["steps"], st["rays"], len(calls) - before)
    # 32 tiles: the rule groups nothing, a pin groups by max(1, int(pin))
    assert set(calls) == {2, 4}
    assert steps[None][2] == 0
    for pin in (2, 4.7):
        n_steps, rays, n_calls = steps[pin]
        assert 1 <= n_calls <= torch_wf.MAX_SHRINK_STAGES + 1 < n_steps
        assert rays == steps[None][1]
        assert np.array_equal(images[pin], images[None])
    assert images[None].mean() > 0.05
    monkeypatch.setattr(torch_config, "SORT_KEY_COARSEN", 0.3)
    assert torch_wf.key_coarsen(9, 404) == 1
    monkeypatch.setattr(torch_config, "SORT_KEY_COARSEN", None)
    assert torch_wf.key_coarsen(9, 404) == 4


def test_bvh_arrays_stay_on_the_host():
    """compile(device) uploads no BVH array while no module reads one;
    compile_arrays() still holds the reference's."""
    scene = torch_scenes.cornell_box(16, 8, 1, sphere_subdiv=2)
    sd = scene.compile("cpu")
    names = {f for f in vars(sd)}
    assert len(torch_scene_mod.HOST_ONLY) == 4
    assert not any(n.startswith("bvh_") for n in names)
    assert all(torch.is_tensor(getattr(sd, n)) for n in names)
    arrays = scene.compile_arrays()
    ref = jax_scenes.cornell_box(16, 8, 1, sphere_subdiv=2).compile()
    for name in torch_scene_mod.HOST_ONLY:
        assert name in arrays and name not in names
        assert (np.asarray(arrays[name]).tobytes()
                == np.asarray(getattr(ref, name)).tobytes()), name
    # every array but the BVH is on the device, beside the one field
    # built there (the streamed sweep's gate boxes)
    assert set(arrays) | {"tri_sub_boxes"} == \
        names | set(torch_scene_mod.HOST_ONLY)


def test_wavefront_stats_say_done():
    _, st = torch_wf.render_wavefront(
        torch_scenes.cornell_box(16, 8, 2, sphere_subdiv=2), seed=1,
        n_lanes=4096, device="cpu")
    assert st["done"] is True
    # what the CLI (main.py) and the on-card check read of the stats
    assert {"pixels", "spp", "seconds", "device", "samples_per_sec",
            "mrays_per_sec", "rays", "steps", "wide_steps", "occupancy",
            "merged", "done"} <= set(st)
