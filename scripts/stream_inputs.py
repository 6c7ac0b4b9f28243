"""The rays that scripts/stream_visits.py, stream_ab.py and
stream_tune.py time the streamed sweep (K5, K5-cull) and the 2-D sweep
(K6) on, and that tests/test_torch_stream_card.py holds K5 to its plain
version on.

Every function takes `cs`, the chip_smoke module of the checkout whose
kernels are under test, and needs of it only what every version since
the streamed path has (FULL, CHECK_LANES, AJAX_*, ajax_scene, ajax_rays,
wavefront_rays), so an older checkout is given the same rays.
"""

from __future__ import annotations

from types import SimpleNamespace


def gate_kw(sd) -> dict:
    """The streamed sweep's gate boxes as stream_sweep takes them, for a
    checkout whose scene data carries them (none before the gate)."""
    if hasattr(sd, "tri_sub_boxes"):
        return {"sub_boxes": sd.tri_sub_boxes}
    return {}


def ajax_inputs(cs, dev) -> SimpleNamespace:
    """On the ajax stand-in (chip_smoke.ajax_scene, 541,696 triangles in
    1,058 slabs): sd, its scene data; rays and shadow, chip_smoke's
    32,768 check rays spread over the image and their shadow rays;
    rays_b and shadow_b, the 131,072 camera and shadow rays of whitted
    batch AJAX_SORTED_BATCH; srt, those shadow rays in the order
    traverse.occluded sorts them."""
    import torch
    from nori_tpu_torch.accel import traverse
    from nori_tpu_torch.render import DEFAULT_BATCH

    scene = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 4, "whitted")
    sd = scene.compile(dev)
    n = cs.AJAX_CHECK_LANES
    w, h = scene.camera.output_size
    q = torch.arange(n, dtype=torch.int64, device=dev) * (
        w * h * scene.sampler.sample_count // n)
    rays, shadow = cs.ajax_rays(scene, sd, dev, q)
    scene16 = cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 16, "whitted")
    q = cs.AJAX_SORTED_BATCH * DEFAULT_BATCH + torch.arange(
        DEFAULT_BATCH, dtype=torch.int64, device=dev)
    rays_b, shadow_b = cs.ajax_rays(scene16, sd, dev, q)
    srt = shadow_b[:, traverse.shadow_order(sd, shadow_b)].contiguous()
    return SimpleNamespace(sd=sd, rays=rays, shadow=shadow, rays_b=rays_b,
                           shadow_b=shadow_b, srt=srt)


#: steps a cbox_scan pool takes before its rays count as steady
CBOX_SCAN_WARM = 8


def cbox_scan_inputs(dev, n_lanes: int = 524288, seed: int = 7):
    """On the benchmark's cbox_scan (the Cornell box with the
    541,660-triangle stand-in, 800x600, path_mis, 32 spp, streamed):
    sd, and what the streamed sweep is handed in one steady eager step
    at n_lanes lanes after CBOX_SCAN_WARM steps: closest, the bounce
    rays; shadow, the shadow rays as traverse.occluded sorts them.
    Built through the checkout's benchmark package (benchmark.port)."""
    import inspect

    import torch
    from benchmark import manifest as mf
    from benchmark.port import build_scene
    from nori_tpu_torch.accel import traverse
    from nori_tpu_torch.integrators.path import MIS
    from nori_tpu_torch.render import prepare
    from nori_tpu_torch.wavefront import make_wavefront_stepper

    man = mf.load()
    desc = mf.scene_builder("cbox_scan")(mf.config(man, "cbox_scan"))
    scene = build_scene(desc, "path_mis", 32)
    sd, spp = prepare(scene, None, dev)
    w, h = scene.camera.output_size
    # an eager step, so that its sweeps are called from the host
    eager = ({"graph": False} if "graph" in inspect.signature(
        make_wavefront_stepper).parameters else {})
    init, step, _, _ = make_wavefront_stepper(scene, MIS, n_lanes,
                                              64 * n_lanes, device=dev,
                                              **eager)
    carry = step(sd, init(seed, 0, w * h * spp), seed)
    for _ in range(CBOX_SCAN_WARM - 1):
        carry = step(sd, carry, seed)
    calls, orig = [], traverse.stream_sweep

    def record(op, keys, bits, rays, any_hit=False, *a, **k):
        calls.append((rays.clone(), any_hit))
        return orig(op, keys, bits, rays, any_hit, *a, **k)

    traverse.stream_sweep = record
    try:
        step(sd, carry, seed)
    finally:
        traverse.stream_sweep = orig
    torch.cuda.synchronize()
    if [ah for _, ah in calls] != [False, True]:
        raise AssertionError(f"a cbox_scan step swept {len(calls)} times: "
                             f"{[ah for _, ah in calls]}")
    return SimpleNamespace(sd=sd, closest=calls[0][0], shadow=calls[1][0])


def room_inputs(cs, dev) -> SimpleNamespace:
    """On the living room (chip_smoke FULL): sd, and the CHECK_LANES
    (131,072) wavefront check rays and their shadow rays."""
    from nori_tpu_torch.scenes_builtin import living_room

    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    sd = scene.compile(dev)
    rays, shadow = cs.wavefront_rays(scene, sd, dev, cs.CHECK_LANES)
    return SimpleNamespace(sd=sd, rays=rays, shadow=shadow)
