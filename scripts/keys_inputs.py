"""The boxes and rays that scripts/keys_visits.py and keys_ab.py time the
two key kernels on: K1 (sweep.entry_min, the per-ray-tile entry keys of
every query) and K3 (sweep.lane_keys, the sort keys of the wavefront and
of a streamed scene's shadow rays).

Every function takes `cs`, the chip_smoke module of the checkout whose
kernels are under test, and needs of it only what every version since
the streamed path has (FULL, CHECK_LANES, AJAX_*, SEED, ajax_scene,
ajax_rays, wavefront_rays), so an older checkout is given the same
inputs.  The renders' own shapes are captured from the render paths:
`capture` records what a run hands to the two wrappers.
"""

from __future__ import annotations

import contextlib
import inspect

#: steps a 524,288-lane pool takes before its rays count as steady (the
#: lanes then hold paths of mixed depths, sorted by their K3 keys)
WARM_STEPS = 8


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of fn's launches: CUDA events around reps
    calls that are enqueued while the card still spins on an earlier
    kernel, so the time between the events holds no wait for the host (a
    wrapper's enqueue takes tens of microseconds, more than these kernels
    run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(4_000_000)  # ~2 ms: the queue fills behind it
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def capture():
    """Records the (bounds, rays) of every K1 and K3 call made inside
    the block: yields (k1_calls, k3_calls), two lists."""
    from nori_tpu_torch import wavefront
    from nori_tpu_torch.accel import sweep, traverse

    k1_calls, k3_calls = [], []

    def recorder(fn, store):
        def wrapped(bounds, rays, *args, **kwargs):
            store.append((bounds, rays))
            return fn(bounds, rays, *args, **kwargs)
        # a wrapper counts its launches on the name it is reached by
        wrapped.launches = 0
        return wrapped

    old = (sweep.entry_min, wavefront.lane_keys, traverse.lane_keys)
    sweep.entry_min = recorder(old[0], k1_calls)
    wavefront.lane_keys = recorder(old[1], k3_calls)
    traverse.lane_keys = recorder(old[2], k3_calls)
    try:
        yield k1_calls, k3_calls
    finally:
        sweep.entry_min, wavefront.lane_keys, traverse.lane_keys = old


def room_inputs(cs, dev):
    """On the living room (chip_smoke FULL, 404 tiles): (scene, sd, k1,
    k3), k1 and k3 dicts {label: (bounds, rays)}: chip_smoke's 131,072
    check rays and their shadow rays (K3 on the 101 coarsened groups the
    wavefront sorts by), and what one steady 524,288-lane step hands the
    two kernels: the sorted rays of its closest query, its shadow rays,
    and the bounced rays K3 keys before the sort."""
    import torch
    from nori_tpu_torch.integrators.path import MIS
    from nori_tpu_torch.scenes_builtin import living_room
    from nori_tpu_torch.wavefront import (
        _coarsen_bounds, key_coarsen, make_wavefront_stepper)

    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    rays, shadow = cs.wavefront_rays(scene, sd, dev, cs.CHECK_LANES)
    kb = _coarsen_bounds(tb, key_coarsen(sd.tri_packed.shape[0],
                                         tb.shape[0]))
    k1 = {"room check closest": (tb, rays), "room check shadow": (tb, shadow)}
    k3 = {"room check": (kb, rays)}
    n = cfg["n_lanes"]
    spp = scene.sampler.sample_count
    w, h = scene.camera.output_size
    # the step's K1 and K3 calls are recorded from an eager step: a
    # graphed step's replay calls neither wrapper
    eager = ({"graph": False} if "graph" in inspect.signature(
        make_wavefront_stepper).parameters else {})
    init, step, _, _ = make_wavefront_stepper(
        scene, MIS, n, 8 * n // spp * spp, device=dev, **eager)
    carry = init(cs.SEED, 0, w * h * spp)
    for _ in range(WARM_STEPS):
        carry = step(sd, carry, cs.SEED)
    with capture() as (c1, c3):
        step(sd, carry, cs.SEED)
    torch.cuda.synchronize()
    if len(c1) != 2 or len(c3) != 1:
        raise AssertionError(f"a wavefront step made {len(c1)} K1 and "
                             f"{len(c3)} K3 calls, expected 2 and 1")
    k1["room step closest"], k1["room step shadow"] = c1
    k3["room step"] = c3[0]
    return scene, sd, k1, k3


def ajax_inputs(cs, dev):
    """On the ajax stand-in (chip_smoke.ajax_scene, 1,058 slabs): (sd,
    k1, k3): chip_smoke's 32,768 check rays and their shadow rays, and
    what whitted batch AJAX_SORTED_BATCH (131,072 samples) hands the two
    kernels: K1 its camera rays and its shadow rays as traverse.occluded
    sorts them, K3 the shadow rays before that sort."""
    import torch
    from nori_tpu_torch.render import DEFAULT_BATCH, make_sample_pass_q

    scene = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 4, "whitted")
    sd = scene.compile(dev)
    tb = sd.tri_tile_bounds
    n = cs.AJAX_CHECK_LANES
    w, h = scene.camera.output_size
    q = torch.arange(n, dtype=torch.int64, device=dev) * (
        w * h * scene.sampler.sample_count // n)
    rays, shadow = cs.ajax_rays(scene, sd, dev, q)
    k1 = {"ajax check closest": (tb, rays), "ajax check shadow": (tb, shadow)}
    k3 = {"ajax check shadow": (tb, shadow)}
    scene16 = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 16, "whitted")
    pass_fn = make_sample_pass_q(scene16, DEFAULT_BATCH, dev)
    with capture() as (c1, c3):
        pass_fn(sd, cs.SEED, cs.AJAX_SORTED_BATCH * DEFAULT_BATCH)
    torch.cuda.synchronize()
    if len(c1) < 2 or not c3:
        raise AssertionError(f"a whitted batch made {len(c1)} K1 and "
                             f"{len(c3)} K3 calls")
    k1["ajax batch closest"], k1["ajax batch shadow sorted"] = c1[0], c1[1]
    k3["ajax batch shadow"] = c3[0]
    return sd, k1, k3


def candidates(bounds, rays, chunk: int = 32768):
    """(N, n_tt) bool: is box j a candidate of live ray i (the slab test
    of the two kernels, as their plain versions compute it)?"""
    import torch
    from nori_tpu_torch.accel import sweep

    out = []
    for c0 in range(0, rays.shape[1], chunk):
        r = rays[:, c0:c0 + chunk]
        cand, _ = sweep._slab(bounds[:, 0:3], bounds[:, 3:6],
                              r[0:3].T[:, None, :],
                              sweep._safe_inv(r[3:6].T)[:, None, :],
                              r[6][:, None], r[7][:, None])
        out.append(cand & (r[6] <= r[7])[:, None])
    return torch.cat(out)


def gate_counts(bounds, rays, groups=(4, 8, 16, 32)) -> dict:
    """Ray-box tests per ray that a gate on boxes around g consecutive
    boxes leaves, from the inputs alone: every ray tests the group boxes,
    and the g boxes of a group only if it enters the group's box
    (`per_ray`), or if any of the 32 consecutive rays of its warp does
    (`per_warp`).  Beside them the dense count n_tt and the mean number
    of candidate boxes of a ray."""
    from nori_tpu_torch.wavefront import _coarsen_bounds

    n_tt, n = bounds.shape[0], rays.shape[1]
    out = dict(dense=n_tt, rays=n,
               candidates_per_ray=float(
                   candidates(bounds, rays).sum(1).double().mean()))
    for g in groups:
        # groups of g, the last one taking the remainder
        enters = candidates(_coarsen_bounds(bounds, g), rays)
        n_g = enters.shape[1]
        per_ray = n_g + g * float(enters.sum(1).double().mean())
        warp = enters.reshape(n // 32, 32, n_g).any(1)
        per_warp = n_g + g * float(warp.sum(1).double().mean())
        out[f"g{g}"] = dict(groups=n_g, per_ray=per_ray, per_warp=per_warp)
    return out
