"""The rays that scripts/stream_visits.py, stream_ab.py and
stream_tune.py time the streamed sweep (K5, K5-cull) and the 2-D sweep
(K6) on.

Every function takes `cs`, the chip_smoke module of the checkout whose
kernels are under test, and needs of it only what every version since
the streamed path has (FULL, CHECK_LANES, AJAX_*, ajax_scene, ajax_rays,
wavefront_rays), so an older checkout is given the same rays.
"""

from __future__ import annotations

from types import SimpleNamespace


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
