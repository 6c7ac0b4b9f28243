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

import math
import time

import torch

from nori_tpu_torch import graphs, spans
from nori_tpu_torch.accel.traverse import count_gate_tally
from nori_tpu_torch.core import rng
from nori_tpu_torch.device import resolve_device  # noqa: F401 (re-export)
from nori_tpu_torch.film import FilmSpec, splat
from nori_tpu_torch.integrators.base import call_stage, run_depths

#: RNG stream of the pixel jitter, shared by camera rays and the splat
JITTER_STREAM = 0xF000
#: work items per batch of `render` (the JAX package's)
DEFAULT_BATCH = 131072


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


def make_sample_pass(scene, spec: FilmSpec, batch: int, device=None):
    """Pass over `batch` pixels of one sample index, splatted into a
    `film.FilmSpec` accumulator with the scatter-add filter, on `device`
    (default: the first CUDA device; resolve_device).

    Returns fn(sd, accum, seed, sample_idx, pix0) -> (accum, dropped,
    rays); lanes past the image are masked, so the last batch may be
    ragged."""
    device = resolve_device(device)
    cam = scene.camera
    w, h = cam.output_size
    n_pixels = w * h
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params(device)
    li = scene.integrator.make_li(scene, device)

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


class _BatchStages:
    """make_sample_pass_q's pass over `batch` work items q = q0 +
    arange(batch) as stages over one carry: a dict of the integrator's
    depth-loop state (integrators.base.DepthLoop) and "q0", the first
    work item, a Python int or a 0-d int64 tensor on the device (the
    graphed batch driver's)."""

    def __init__(self, scene, batch: int, device):
        w, h = scene.camera.output_size
        self.scene, self.batch, self.device = scene, batch, device
        self.spp = scene.sampler.sample_count
        self.n_pixels = w * h
        self.total_q = w * h * self.spp
        self.cam_params = scene.camera.ray_params(device)
        self.loop = scene.integrator.make_depth(scene, device)

    def lanes(self, q0):
        return q0 + torch.arange(self.batch, dtype=torch.int64,
                                 device=self.device)

    def depth(self, sd, carry: dict, k: int, seed) -> dict:
        """Depth k of the batch; depth 0 starts from the camera rays of
        its work items (pixels past the image clamped to the last) and
        the loop's init.  Returns the next carry."""
        q0 = carry["q0"]
        q = self.lanes(q0)
        if k == 0:
            pix = torch.clamp_max(q // self.spp, self.n_pixels - 1)
            _, o, d, mint, maxt = camera_rays(self.scene, self.cam_params,
                                              pix, q, seed)
            state = self.loop.init(o, d, mint, maxt)
        else:
            state = {n: v for n, v in carry.items() if n != "q0"}
        return {"q0": q0, **self.loop.body(sd, state, k, seed, q)}

    def trace(self, sd, carry: dict, seed, run=call_stage) -> dict:
        """The batch's depths from a carry holding q0 (run_depths; run
        replays a depth in the graphed driver)."""
        return run_depths(lambda c, k: self.depth(sd, c, k, seed), carry,
                          self.loop.max_depth, run)

    def values(self, carry: dict) -> torch.Tensor:
        """The batch's radiance (batch, 3), zero past the last work
        item."""
        in_range = self.lanes(carry["q0"]) < self.total_q
        return torch.where(in_range[:, None], carry["L"], 0.0)


def make_sample_pass_q(scene, batch: int, device=None):
    """Pass over `batch` work items q = pixel * spp + sample, on `device`
    (default: the first CUDA device; resolve_device).

    Returns fn(sd, seed, q0) -> (L (batch, 3), rays).  The RNG streams
    are keyed by q exactly as make_sample_pass keys them by
    pixel * spp + sample_idx, so the two batchings give the same sample
    values."""
    device = resolve_device(device)
    stages = _BatchStages(scene, batch, device)

    def pass_fn(sd, seed, q0: int):
        carry = stages.trace(sd, {"q0": q0}, seed)
        return stages.values(carry), carry["rays"]

    return pass_fn


class _PendingCount:
    """A device count read on the host one window late: on a CUDA
    device the copy is asynchronous and waits only for the work queued
    before it, not for the steps enqueued since.  The event that marks
    the copy's end is recorded on the count's card, whatever the
    thread's current device."""

    def __init__(self, count: torch.Tensor):
        if count.is_cuda:
            self._host = count.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(count.device))
        else:
            self._host, self._event = count, None

    def value(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


class Solo:
    """The collectives of a render on one device, with no group: rank 0
    of 1.  parallel.py's take their place across the ranks of a group,
    so one driver serves both."""

    rank, size = 0, 1
    #: handle on the pool's occupancy, read a window later
    count = _PendingCount

    @staticmethod
    def gather_ints(local: torch.Tensor) -> torch.Tensor:
        return local.reshape(1).to(torch.int64)

    @staticmethod
    def gather(t: torch.Tensor) -> list:
        return [t]

    @staticmethod
    def broadcast(t: torch.Tensor) -> torch.Tensor:
        return t


def prepare(scene, spp: int | None, device):
    """Compile `scene` on `device` and fix its sample count; returns
    (scene data, spp)."""
    with spans.span("prepare"):
        sd = scene.compile(device)
        if spp is not None:
            scene.sampler.sample_count = spp
        scene.integrator.preprocess(scene)
    return sd, scene.sampler.sample_count


class _GraphedBatch:
    """make_batch_pass's pass_fn(sd, film, seed, q0) -> (film, rays (1,))
    on one device with no group, its stages replayed as CUDA graphs over
    one static carry (graphs.StaticCarry; on a card with the sweep
    backend, graphs.graph_replay).

    The carry's q0 is a 0-d int64 on the device, which the splat stage
    advances by the batch, so no stage reads a host value that changes
    from batch to batch.  A call whose q0 is not the one the static
    carry holds (the first batch of a render), or with another sd, seed
    or film, drops the graphs and runs the stages eagerly from q0 filled
    on the device; its carry is written into the static carry, which it
    becomes the first time.  On the static carry each stage replays its
    graph, captured the first time a batch reaches it: depth 0 (the
    camera rays, the integrator's init and its first depth), then each
    depth k while the host reads a live lane between graphs (`sync.alive`,
    as the eager loop reads it), then the splat.  Same work, same
    samples, same order as the eager pass.  A replay counts what its
    stage counts eagerly (graphs.Capture); the counter `batches.graphed`
    counts the batches that replays served.  The rays returned are a
    clone: the next replay overwrites the static carry.  The image's
    last batch releases the graphs and the carry (release).
    """

    def __init__(self, stages: _BatchStages, splat_chunk, device):
        self._stages, self._splat, self._device = stages, splat_chunk, device
        self._static = graphs.StaticCarry(device)
        self._next = None

    def __call__(self, sd, film, seed, q0: int):
        stages, static = self._stages, self._static
        nxt = self._next
        replay = (nxt is not None and nxt[0] is sd and nxt[1] is film
                  and nxt[2] == seed and nxt[3] == q0)
        if replay:
            carry = static.carry

            def run(key, fn, c):
                return static.replay(key, fn)
        else:
            static.drop_graphs()
            carry = {"q0": torch.full((), q0, dtype=torch.int64,
                                      device=self._device)}
            run = call_stage

        def splat(c):
            self._splat(film, stages.values(c), seed, c["q0"],
                        stages.total_q)
            return {**c, "q0": c["q0"] + stages.batch}

        with spans.span("batch"):
            carry = stages.trace(sd, carry, seed, run)
            with spans.span("splat"):
                carry = run("splat", splat, carry)
        if replay:
            spans.count("batches.graphed")
        else:
            static.keep(carry)
        rays = static.carry["rays"].reshape(1).clone()
        self._next = (sd, film, seed, q0 + stages.batch)
        if q0 + stages.batch >= stages.total_q:
            self.release()
        return film, rays

    def release(self):
        """Drop the graphs and the static carry once the work they
        launched has run.  The graphs' memory pools go back to the card
        at the next torch.cuda.empty_cache() (`render` calls it after the
        image), or when the allocator runs short."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._static.release()
        self._next = None


def make_batch_pass(scene, batch: int, device=None, coll=Solo):
    """Pass adding one batch of `batch` work items q to the dense film on
    `device` (default: the first CUDA device; resolve_device), the batch
    shared by coll's ranks: rank r traces its contiguous
    batch // coll.size items, rank 0 gathers them in q order and splats
    the whole batch (wavefront.make_dense_splat at `batch`), so the film
    is the same at any rank count.

    Returns (new_film, pass_fn, finalize); pass_fn(sd, film, seed, q0)
    -> (film, rays (coll.size,) per rank); film is None on other ranks.
    With no group (Solo) on a device that replays CUDA graphs
    (graphs.graph_replay), pass_fn is a _GraphedBatch; a group's pass
    runs eagerly, since a collective lies between its trace and its
    splat.
    """
    from nori_tpu_torch.wavefront import make_dense_splat

    device = resolve_device(device)
    share = batch // coll.size
    total_q = math.prod(scene.camera.output_size) * \
        scene.sampler.sample_count
    with spans.span("build"):
        new_film, splat_chunk, finalize = make_dense_splat(scene, batch,
                                                           device)
        if coll is Solo and graphs.graph_replay(device):
            return new_film, _GraphedBatch(_BatchStages(scene, batch, device),
                                           splat_chunk, device), finalize
        trace = make_sample_pass_q(scene, share, device)

    def pass_fn(sd, film, seed, q0: int):
        with spans.span("batch"):
            vals, rays = trace(sd, seed, q0 + coll.rank * share)
            with spans.span("gather"):
                rays = coll.gather_ints(rays)
                parts = coll.gather(vals)
            if parts is not None:
                with spans.span("splat"):
                    vals = parts[0] if len(parts) == 1 else torch.cat(parts)
                    film = splat_chunk(film, vals, seed, torch.full(
                        (), q0, dtype=torch.int64, device=device), total_q)
        return film, rays

    return new_film, pass_fn, finalize


def render_batches(scene, sd, spp: int, seed: int, batch: int | None,
                   device, coll=Solo, verbose: bool = False):
    """The batch loop of `render` and parallel.render_sharded over
    coll's ranks; returns (image (H, W, 3) numpy, stats), the same image
    on every rank."""
    w, h = scene.camera.output_size
    total_q = w * h * spp
    if batch is None:
        batch = min(DEFAULT_BATCH, total_q)
    # whole pixels, shared evenly by the ranks
    unit = math.lcm(spp, coll.size)
    batch = max(unit, (batch // unit) * unit)
    new_film, pass_fn, finalize = make_batch_pass(scene, batch, device, coll)
    film = new_film() if coll.rank == 0 else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    ray_counts = []
    n_batches = (total_q + batch - 1) // batch
    for b in range(n_batches):
        film, rays = pass_fn(sd, film, seed, b * batch)
        spans.count("batches")
        ray_counts.append(rays)
        if verbose and coll.rank == 0 \
                and (b + 1) % max(1, n_batches // 10) == 0:
            print(f"  batch {b + 1}/{n_batches}  ({time.time() - t0:.2f}s)")
    img = finalize(film) if coll.rank == 0 else torch.empty(
        (h, w, 3), dtype=torch.float32, device=device)
    with spans.sync("copy_out"):
        img = coll.broadcast(img).cpu().numpy()
        count_gate_tally(device)
    elapsed = time.time() - t0
    with spans.sync("rays"):
        total_rays = int(torch.cat(ray_counts).sum())
    return img, {
        "spp": spp,
        "seconds": elapsed,
        "pixels": w * h,
        "samples_per_sec": total_q / max(elapsed, 1e-9),
        "rays": total_rays,
        "mrays_per_sec": total_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
        "devices": coll.size,
    }


def render(scene, spp: int | None = None, seed: int = 0,
           verbose: bool = False, batch: int | None = None, device=None):
    """Render a scene with the batch driver on `device` (default: the
    first CUDA device; resolve_device); returns (image (H, W, 3) numpy,
    stats dict)."""
    device = resolve_device(device)
    with spans.span("image"):
        sd, spp = prepare(scene, spp, device)
        out = render_batches(scene, sd, spp, seed, batch, device,
                             verbose=verbose)
        del sd
        if graphs.graph_replay(device):
            # the pools of the graphs that the pass released after its
            # last batch, and all the image cached, go back to the card
            torch.cuda.empty_cache()
    return out


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
