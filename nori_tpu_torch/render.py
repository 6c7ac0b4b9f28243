"""Render drivers.

Port of `nori_tpu/render.py`.  `render` is the batch driver of the
non-path integrators (normals/simple/ao/whitted; it takes the path
family too): each batch traces DEFAULT_BATCH work items q = pixel * spp
+ sample as one wavefront (camera rays -> the integrator's li) and adds
them to the film with the scatter-free dense splat
(wavefront.make_dense_splat).  The RNG is keyed by (seed, q), so a
sample's value does not depend on batching.  `render_to_files` sends
the path family to the persistent wavefront and the rest to `render`.
"""

from __future__ import annotations

import time

import torch

from nori_tpu_torch.core import rng
from nori_tpu_torch.film import FilmSpec, splat

#: RNG stream of the pixel jitter, shared by camera rays and the splat
JITTER_STREAM = 0xF000
#: work items per batch of `render` (the JAX package's)
DEFAULT_BATCH = 131072


def resolve_device(device) -> torch.device:
    """The device a render runs on: `device`, by default the first CUDA
    device.  Raises RuntimeError when that is a CUDA device and none is
    available: a render goes to the CPU only when asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device available for {dev}: pass device='cpu' to "
            "render on the CPU")
    return dev


def camera_rays(scene, cam_params, pix, lanes, seed):
    """Jittered camera rays through pixels `pix`, the jitter keyed by
    the lanes' sample ids; returns (positions, o, d, mint, maxt)."""
    cam = scene.camera
    w = cam.output_size[0]
    jitter = rng.uniform2(seed, lanes, JITTER_STREAM)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    pos = torch.stack([px, py], dim=-1) + jitter
    return (pos, *type(cam).sample_rays(cam_params, pos))


def make_sample_pass(scene, spec: FilmSpec, batch: int, device="cpu"):
    """Pass over `batch` pixels of one sample index, splatted into a
    `film.FilmSpec` accumulator with the scatter-add filter.

    Returns fn(sd, accum, seed, sample_idx, pix0) -> (accum, dropped,
    rays); lanes past the image are masked, so the last batch may be
    ragged."""
    cam = scene.camera
    w, h = cam.output_size
    n_pixels = w * h
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params(device)
    li = scene.integrator.make_li(scene)

    def sample_pass(sd, accum, seed, sample_idx: int, pix0: int):
        pix = pix0 + torch.arange(batch, dtype=torch.int64, device=device)
        in_range = pix < n_pixels
        pix = torch.clamp_max(pix, n_pixels - 1)
        lanes = pix * spp + sample_idx
        pos, o, d, mint, maxt = camera_rays(scene, cam_params, pix, lanes,
                                            seed)
        vals, aux = li(sd, o, d, mint, maxt, seed, lanes)
        vals = torch.where(in_range[:, None], vals, 0.0)
        pos = torch.where(in_range[:, None], pos, -1e6)
        accum, dropped = splat(spec, cam.rfilter, accum, pos, vals)
        return accum, dropped, aux["rays"]

    return sample_pass


def make_sample_pass_q(scene, batch: int, device="cpu"):
    """Pass over `batch` work items q = pixel * spp + sample.

    Returns fn(sd, seed, q0) -> (L (batch, 3), rays).  The RNG streams
    are keyed by q exactly as make_sample_pass keys them by
    pixel * spp + sample_idx, so the two batchings give the same sample
    values."""
    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params(device)
    li = scene.integrator.make_li(scene)
    n_pixels = w * h

    def pass_fn(sd, seed, q0: int):
        q = q0 + torch.arange(batch, dtype=torch.int64, device=device)
        in_range = q < n_pixels * spp
        pix = torch.clamp_max(q // spp, n_pixels - 1)
        _, o, d, mint, maxt = camera_rays(scene, cam_params, pix, q, seed)
        vals, aux = li(sd, o, d, mint, maxt, seed, q)
        return torch.where(in_range[:, None], vals, 0.0), aux["rays"]

    return pass_fn


def render(scene, spp: int | None = None, seed: int = 0,
           verbose: bool = False, batch: int | None = None, device=None):
    """Render a scene with the batch driver on `device` (default: the
    first CUDA device; resolve_device); returns (image (H, W, 3) numpy,
    stats dict)."""
    from nori_tpu_torch.wavefront import make_dense_splat

    device = resolve_device(device)
    sd = scene.compile(device)
    w, h = scene.camera.output_size
    if spp is None:
        spp = scene.sampler.sample_count
    else:
        scene.sampler.sample_count = spp
    scene.integrator.preprocess(scene)

    total_q = w * h * spp
    if batch is None:
        batch = min(DEFAULT_BATCH, total_q)
    batch = max(spp, (batch // spp) * spp)
    pass_fn = make_sample_pass_q(scene, batch, device)
    new_film, splat_chunk, finalize = make_dense_splat(scene, batch, device)

    film = new_film()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    ray_counts = []
    n_batches = (total_q + batch - 1) // batch
    for b in range(n_batches):
        q0 = b * batch
        vals, rays = pass_fn(sd, seed, q0)
        film = splat_chunk(film, vals, seed, q0, total_q)
        ray_counts.append(rays)
        if verbose and (b + 1) % max(1, n_batches // 10) == 0:
            print(f"  batch {b + 1}/{n_batches}  ({time.time() - t0:.2f}s)")
    img = finalize(film).cpu().numpy()
    elapsed = time.time() - t0
    total_rays = int(torch.stack(ray_counts).sum())
    return img, {
        "spp": spp,
        "seconds": elapsed,
        "pixels": w * h,
        "samples_per_sec": total_q / max(elapsed, 1e-9),
        "rays": total_rays,
        "mrays_per_sec": total_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
    }


def render_to_files(scene, out_base: str, spp: int | None = None,
                    seed: int = 0, verbose: bool = False, device=None,
                    n_lanes: int = 131072, preview: bool = False,
                    checkpoint: bool = False, view: bool = False):
    """Render and write <base>.exr + tonemapped <base>.png
    (src/main.cpp:140-150).  Path-family integrators use the
    persistent wavefront (n_lanes wide), the others the batch driver.
    preview writes <base>_preview.png after every chunk; checkpoint
    dumps resumable render state at <base>.ckpt after every chunk and
    removes it on completion (both path family only); view draws the
    film in the terminal after every chunk (nori_tpu_torch.tui, the
    reference's NoriScreen, src/gui.cpp:19-132), once at the end for
    the batch driver.
    Returns (image, stats)."""
    from nori_tpu_torch.bitmap import write_exr, write_png
    from nori_tpu_torch.integrators import PATH_FAMILY
    from nori_tpu_torch.wavefront import render_wavefront

    on_chunk = None
    if view:
        from nori_tpu_torch.tui import live_view

        def on_chunk(img, frac):
            live_view(img, status=f"rendering... {100 * frac:.0f}%")

    if scene.integrator.plugin_name in PATH_FAMILY:
        img, stats = render_wavefront(
            scene, spp=spp, seed=seed, n_lanes=n_lanes, verbose=verbose,
            device=device,
            preview_path=(out_base + "_preview.png") if preview else None,
            checkpoint_path=(out_base + ".ckpt") if checkpoint else None,
            on_chunk=on_chunk)
    else:
        img, stats = render(scene, spp=spp, seed=seed, verbose=verbose,
                            device=device)
        if on_chunk is not None:
            on_chunk(img, 1.0)
    write_exr(out_base + ".exr", img)
    write_png(out_base + ".png", img)
    return img, stats
