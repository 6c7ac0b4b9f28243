"""Multi-device rendering: sample-space data parallelism over ranks.

Port of `nori_tpu/parallel.py`.  The JAX package drives every device of
a mesh from one process (`shard_map`) and reduces with `psum`.  Here
each device has a process of its own, a rank of a `torch.distributed`
group (`torchrun --nproc-per-node=N`, or `spawn` on one host), and with
it a host thread of its own to enqueue its steps: both renderers are
bound by the host's enqueues, which one thread would serialise over N
devices.  The collectives carry what `psum` carried: the occupancy
counts, the ranks' results, gathered to rank 0 and folded there in
rank order, and the ray counts.

Both drivers are the single-device ones (wavefront.render_chunks and
render.render_batches) with a group's collectives in place of
render.Solo.  Determinism: work item q keys the counter-based RNG, so a
sample's value does not depend on which rank renders it, and rank 0
splats the ranks' work in q order.  The sharded wavefront's image is
therefore render_wavefront(chunk=chunk_dev)'s, and the batch driver's
render(batch=batch)'s, bit for bit, for any rank count.

Where a collective's buffers live follows the group's backend, never a
caught error: "nccl" takes tensors on the rank's card, "gloo" host
tensors, copied to and from the render's device explicitly.  NCCL
refuses two ranks on one card; gloo ranks may share one.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from nori_tpu_torch import spans
from nori_tpu_torch.accel.sweep import launch_counters
from nori_tpu_torch.device import resolve_device
from nori_tpu_torch.integrators.path import MIS
from nori_tpu_torch.render import (
    Solo, _PendingCount, make_batch_pass, prepare, render_batches)
from nori_tpu_torch.wavefront import (
    CHECK_EVERY, MAX_DEPTH, merged_step, release_graphs, render_chunks,
    wavefront_stages)

#: default per-rank lane pool: the JAX package's value, kept for parity
#: of the two drivers' step counts; not measured on the H100 (ROADMAP P3)
N_LANES_DEV_DEFAULT = 524288


def rank_device(device, rank: int) -> torch.device:
    """The device of local rank `rank`: `device`, by default CUDA
    (device.resolve_device); a CUDA device without an index is card
    `rank`.  Raises when this host has no such card: ranks share a card
    only when given it by index ("cuda:0"), and only on gloo."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} has no card of its own: this host has "
                f"{torch.cuda.device_count()} CUDA device(s); pass "
                "device='cuda:0' and backend 'gloo' to share one")
        device = torch.device("cuda", rank)
    return device


def make_group(backend: str | None = None, device=None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None):
    """Join the default process group; returns (group, rank, world_size,
    device) of this process.

    Under torchrun (LOCAL_RANK in the environment and no init_method) it
    joins from the environment.  Otherwise it joins at `init_method`
    ("file://..." or "tcp://localhost:PORT") as `rank` of `world_size`,
    all three required, `rank` also taken as the local rank.  The device
    is rank_device(device, local rank): by default the local rank's
    card.  The backend defaults to the device's: "nccl" on a CUDA
    device, "gloo" on the CPU.  Ranks on the CPU split this process's
    threads between them (torch.get_num_threads(): the host's cores
    unless OMP_NUM_THREADS sets fewer), else each would take all of
    them.
    """
    if init_method is None and "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        # env:// reads the rank and world size from the environment
        init_method, rank, world_size = "env://", -1, -1
    elif init_method is None or rank is None or world_size is None:
        raise ValueError("outside torchrun, make_group needs init_method, "
                         "rank and world_size")
    else:
        local = rank
    device = rank_device(device, local)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    n = dist.get_world_size()
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    return dist.group.WORLD, dist.get_rank(), n, device


def _rank_main(fn, args, rank: int, n: int, backend, device, tmp: str):
    try:
        _, _, _, device = make_group(
            backend, device, "file://" + os.path.join(tmp, "rdzv"), rank, n)
        result = fn(device, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, n: int, *args, backend: str | None = None, device=None,
          timeout: float = 900.0):
    """Run fn(device, *args) in n ranks on this host and return rank 0's
    result; device is the rank's, rank_device(device, rank): by default
    rank r renders on card r, and n must not exceed the cards.

    Each rank is a process started by torch.multiprocessing with
    "spawn" that first joins a group of n (make_group) through a
    file:// rendezvous in a new temporary directory, so no port is taken
    and concurrent launches never meet.  fn must be a module-level
    function (it is pickled by name).  Raises RuntimeError with the
    rank's traceback as soon as a rank fails, and TimeoutError when the
    ranks have not all ended after `timeout` seconds; either way the
    ranks still running are killed.
    """
    devices = [rank_device(device, r) for r in range(n)]
    if (backend or ("nccl" if devices[0].type == "cuda" else "gloo")) \
            == "nccl" and len(set(devices)) < n:
        raise ValueError(f"nccl takes one card per rank, not {devices}")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, r, n, backend, str(devices[r]),
                                   tmp))
                 for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(_rank_failure(tmp, procs, bad[0]))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after "
                                       f"{timeout} s")
                procs[0].join(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(_rank_failure(tmp, procs, bad[0]))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _rank_failure(tmp: str, procs, r: int) -> str:
    err = os.path.join(tmp, f"rank{r}.err")
    text = open(err).read() if os.path.exists(err) else ""
    return f"rank {r} of {len(procs)} exited with {procs[r].exitcode}\n{text}"


def collectives(group, device: torch.device):
    """The collectives of one render on this rank of `group`: group None
    takes the default group once one is initialised, else the render is
    one rank with none (render.Solo), which refuses to run when
    WORLD_SIZE says there are more."""
    if group is None:
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process "
                "group is initialised: call parallel.make_group() first, "
                "or every rank renders the whole image")
        else:
            return Solo
    return _Collectives(group, device)


class _Collectives:
    """render.Solo's collectives over the ranks of `group`, their
    buffers where the group's backend takes them."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.root = dist.get_global_rank(group, 0)
        nccl = dist.get_backend(group) == "nccl"
        if nccl and device.type != "cuda":
            raise ValueError(f"an nccl group renders on CUDA, not {device}")
        self.buf = device if nccl else torch.device("cpu")

    def gather_ints(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's 0-d integer `local`, in rank order: an int64
        (world_size,) tensor where the backend takes it, on nccl gathered
        on the card without a wait for the host."""
        local = local.reshape(1).to(self.buf, torch.int64)
        out = torch.empty(self.size, dtype=torch.int64, device=self.buf)
        dist.all_gather_into_tensor(out, local, group=self.group)
        return out

    def count(self, local: torch.Tensor):
        """Handle on the largest of the ranks' counts `local` (0-d),
        read a window later (wavefront.run_chunk's `count`).  Where the
        collective's buffers are the render's device (nccl; gloo on the
        CPU) the gather is made now, on nccl queued behind the steps and
        copied without a wait; a gloo group rendering on a card gathers
        on the host when it reads the counts, one window late, as it
        reads its own."""
        if self.buf.type == self.device.type:
            return _PendingCount(self.gather_ints(local).amax())
        return _HostMax(_PendingCount(local), self)

    def gather(self, t: torch.Tensor):
        """Rank 0: every rank's `t` (same shape on all), in rank order,
        on the render's device; other ranks: None."""
        t = t.to(self.buf).contiguous()
        parts = ([torch.empty_like(t) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(t, parts, dst=self.root, group=self.group)
        return None if parts is None else [p.to(self.device) for p in parts]

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank (the others pass a tensor of the
        same shape and type), on the render's device."""
        t = t.to(self.buf).contiguous()
        dist.broadcast(t, src=self.root, group=self.group)
        return t.to(self.device)


class _HostMax:
    """A gloo group's pending largest count: the rank's own count read
    one window late, then gathered on the host."""

    def __init__(self, local: _PendingCount, coll: _Collectives):
        self._local, self._coll = local, coll

    def value(self) -> int:
        return int(self._coll.gather_ints(
            torch.tensor(self._local.value())).amax())


def make_sharded_sample_pass(scene, batch: int, group=None, device=None):
    """Pass adding one global batch of `batch` work items q = pixel *
    spp + sample to the film, sharded over the group's ranks
    (nori_tpu/parallel.py:36, which shards a batch of pixels of one
    sample index and reduces per-rank films with psum).

    Returns (new_film, pass_fn, finalize) of render.make_batch_pass:
    pass_fn(sd, film, seed, q0) -> (film, rays per rank).  Rank r traces
    its contiguous batch // world_size items; rank 0 gathers them in q
    order and splats the batch once, so the film is the single-device
    batch driver's at any rank count.
    """
    device = resolve_device(device)
    coll = collectives(group, device)
    if batch % coll.size:
        raise ValueError(f"batch {batch} is not a multiple of the "
                         f"{coll.size} ranks")
    return make_batch_pass(scene, batch, device, coll)


def make_sharded_wavefront(scene, mode: int, group, n_lanes_dev: int,
                           chunk_dev: int, max_depth: int = MAX_DEPTH,
                           sort_rays: bool | None = None, device=None):
    """This rank's wavefront of a sharded render
    (nori_tpu/parallel.py:116): (steppers, count) for
    wavefront.run_chunk, steppers at n_lanes_dev lanes and chunk_dev work
    items with the JAX driver's one shrink stage, to
    max(1024, n_lanes_dev // SHRINK_FACTOR) lanes, so that its steps and
    wide steps are the JAX driver's; count is the pending largest
    occupancy over the ranks."""
    device = resolve_device(device)
    coll = collectives(group, device)
    if chunk_dev % scene.sampler.sample_count:
        raise ValueError("chunk_dev must be pixel-aligned")
    steppers = wavefront_stages(scene, mode, n_lanes_dev, chunk_dev,
                                max_depth, sort_rays, device,
                                merged_step(scene, mode), max_stages=1)
    return steppers, coll.count


def render_sharded_wavefront(scene, group=None, spp: int | None = None,
                             seed: int = 0,
                             n_lanes_dev: int = N_LANES_DEV_DEFAULT,
                             chunk_dev: int | None = None,
                             max_iters: int = 100000,
                             check_every: int = CHECK_EVERY,
                             checkpoint_path: str | None = None,
                             verbose: bool = False, device=None):
    """Sharded persistent-wavefront render (nori_tpu/parallel.py:267) on
    this rank of `group` (collectives()), on `device` (default:
    the first CUDA device; device.resolve_device).

    Work item space q is cut into global chunks of world_size *
    chunk_dev items; rank r renders [q0 + r * chunk_dev, q0 + (r + 1) *
    chunk_dev) of each with its own n_lanes_dev-lane pool, in lockstep
    with the others (make_sharded_wavefront): every check_every steps
    the ranks gather their occupancy and take the same stop and shrink
    decisions from the largest count.  Rank 0 splats the ranks' radiance
    in q order (wavefront.render_chunks), so the image is
    render_wavefront(chunk=chunk_dev)'s, bit for bit, at any rank count.
    checkpoint_path: rank 0 dumps (film, cursor, rays) after every
    global chunk under the single-device key plus ":ndev=<world_size>"
    (the JAX package's key string), and a render run again with the same
    arguments resumes from it; the file is removed when the render is
    done.  max_iters bounds the occupancy windows of one chunk.

    Returns ((H, W, 3) numpy image, stats), the same image on every rank.
    Each rank captures its own CUDA graphs (wavefront._GraphedStep;
    the collectives stay between the steps) and releases them when the
    render returns.
    """
    device = resolve_device(device)
    coll = collectives(group, device)
    with spans.span("image"):
        sd, spp = prepare(scene, spp, device)
        w, h = scene.camera.output_size
        mode = getattr(scene.integrator, "mode", MIS)
        max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)
        n_dev = coll.size
        total_q = w * h * spp
        n_lanes_dev = min(n_lanes_dev, max(4096, total_q // n_dev + 1))
        if chunk_dev is None:
            chunk_dev = min(-(-total_q // n_dev), 64 * n_lanes_dev)
        chunk_dev = max(spp, (chunk_dev // spp) * spp)
        steppers, _ = make_sharded_wavefront(scene, mode, group, n_lanes_dev,
                                             chunk_dev, max_depth,
                                             device=device)
        try:
            return render_chunks(
                scene, sd, spp, seed, steppers, chunk_dev, device, coll,
                check_every, max_iters * check_every, checkpoint_path,
                f":ndev={n_dev}", verbose=verbose)
        finally:
            release_graphs(steppers)


def render_sharded(scene, group=None, spp: int | None = None, seed: int = 0,
                   batch: int | None = None, device=None):
    """Sharded batch render (nori_tpu/parallel.py:423) on this rank of
    `group` (collectives()), on `device`: the batch driver
    (render.render_batches) with each global batch of `batch` work items
    (default render.DEFAULT_BATCH) shared by the ranks.  The image is
    render(batch=batch)'s, bit for bit, at any rank count.  Returns
    ((H, W, 3) numpy image, stats), the same image on every rank."""
    device = resolve_device(device)
    coll = collectives(group, device)
    with spans.span("image"):
        sd, spp = prepare(scene, spp, device)
        return render_batches(scene, sd, spp, seed, batch, device, coll)


def render_jobs(device, jobs, switches=None) -> list:
    """Rank body for `spawn` (fn(device, ...)): set the
    nori_tpu_torch.config `switches` (a spawned rank starts from a fresh
    import, so the parent's are not its), then render each job on the
    default group on this rank's `device`.

    jobs: (scene_fn, scene_kwargs, driver, render_kwargs), scene_fn a
    module-level function that builds the scene, driver "wavefront"
    (render_sharded_wavefront) or "batch" (render_sharded).  Returns
    [(image, stats, launches)], launches the kernels' launch counts
    during the render on each rank, in rank order (the counts are per
    process, so each rank reads its own).
    """
    from nori_tpu_torch import config

    for k, v in (switches or {}).items():
        if not hasattr(config, k):
            raise AttributeError(f"nori_tpu_torch.config has no {k}")
        setattr(config, k, v)
    drivers = {"wavefront": render_sharded_wavefront, "batch": render_sharded}
    counters = launch_counters()
    out = []
    for scene_fn, scene_kwargs, driver, kwargs in jobs:
        scene = scene_fn(**scene_kwargs)
        for f in counters.values():
            f.launches = 0
        img, stats = drivers[driver](scene, device=device, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mine = {k: f.launches for k, f in counters.items()}
        launches = [None] * dist.get_world_size()
        dist.all_gather_object(launches, mine)
        out.append((img, stats, launches))
    return out
