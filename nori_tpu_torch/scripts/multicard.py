"""The sharded renderers (nori_tpu_torch.parallel) on several cards, one
rank per card over NCCL: the port's counterpart of
`__graft_entry__.dryrun_multichip`, and the full-width renders at 1, 2,
4, ... ranks up to --ranks.

Usage (from the repository root, on a host with --ranks cards):
    python -m nori_tpu_torch.scripts.multicard --ranks 4 [--out F]

Phases, in this order, each of which raises on a failed check:

  dry-run      dryrun_multichip's assertion set at its own shapes: one
               sharded batch pass on the 64x32, 1-spp Cornell box (batch
               256 per rank) with a finite film; the 32x16 sharded
               wavefront (256 lanes per rank), finite; the 96x54, 2-spp,
               detail-2 living room at 4,096 lanes per rank, twice: rays
               equal to render_wavefront(chunk=chunk_dev) on one device,
               the repeat bit-identical, the image bit-equal to that
               render's (the JAX package allows 1e-5), rays on every rank.
  living-room  the 1280x720, 32-spp, detail-5 living room through
               render_sharded_wavefront at 524,288 lanes and 7,372,800
               work items per rank (chip_smoke.py's checkpointed chunk):
               a warm render and two measured ones per rank count, each
               rank count in a spawn of its own; each image's SHA-1 and
               rays equal to render_wavefront(chunk=7,372,800) on card 0,
               K1, K2 and K3 launched on every rank.
  ajax         ajax_rough (whitted, 16 spp) and ajax_normals (4 spp) at
               768x768 through render_sharded at the default global batch
               (131,072) and at four times it, per rank count: each image
               and its rays equal to render(batch=...) on card 0, K1 and
               K5 (and for whitted K3) launched on every rank.
  off-card0    from this process, its current device left at cuda:0: a
               parity living room (chip_smoke.PARITY's shapes) on cuda:1
               bit-equal to the one on cuda:0, and K1, K2, K3 and K5 on
               the last rank's card against their plain versions on
               chip_smoke.py's check inputs (made on cuda:0, copied).

By default rank r renders on cuda:r over NCCL; with fewer cards than
--ranks it raises, and it never falls back to gloo, to the CPU or to a
kernel's plain version.  `--backend gloo --device cpu` runs the dry run
alone on the CPU, for the port's CPU tests.  The record (default
MULTICARD_torch.json) holds every card's name and power limit
(nvidia-smi), the NCCL version, the host's cores, the NCCL_* variables
set, and every check and number of the phases run; on a failed check
the script names the phase, records it and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from nori_tpu_torch import parallel
from nori_tpu_torch.bench import AJAX_SIZE, _sha1, ajax_scene
from nori_tpu_torch.render import DEFAULT_BATCH, prepare, render
from nori_tpu_torch.scenes_builtin import cornell_box, living_room
from nori_tpu_torch.wavefront import render_wavefront

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_JSON = "MULTICARD_torch.json"
SEED = 0

#: dryrun_multichip's shapes (__graft_entry__.py): the Cornell box of
#: the batch pass and of the small wavefront, the living room of the
#: assertion set, and their lanes per rank
DRY_BOX = dict(width=64, height=32, spp=1, integrator="path_mis",
               sphere_subdiv=1)
DRY_BATCH_PER_RANK = 256
DRY_WAVE = dict(width=32, height=16, spp=1, integrator="path_mis",
                sphere_subdiv=1)
DRY_WAVE_LANES = 256
DRY_ROOM = dict(width=96, height=54, spp=2, detail=2)
DRY_ROOM_LANES = 4096

#: the full-width living room (chip_smoke.FULL) and its chunk per rank,
#: chip_smoke's total_q // CKPT_CHUNKS
FULL = dict(width=1280, height=720, spp=32, detail=5)
FULL_LANES = 524288
FULL_CHUNK = 1280 * 720 * 32 // 4
#: the ajax renders (chip_smoke.AJAX_FULL): name -> (integrator, spp),
#: and the two global batches each runs at
AJAX = {"ajax_rough": ("whitted", 16), "ajax_normals": ("normals", 4)}
AJAX_BATCHES = (DEFAULT_BATCH, 4 * DEFAULT_BATCH)
#: measured renders after the warm one
MEASURED = 2

#: the kernels each path must launch on every rank (the dry run's living
#: room has 12 tiles and sorts its lanes without K3, which runs above 28)
ROOM_KERNELS = ("entry_min", "resident_sweep", "lane_keys")
DRY_ROOM_KERNELS = ("entry_min", "resident_sweep")
AJAX_KERNELS = {"whitted": ("entry_min", "stream_sweep", "lane_keys"),
                "normals": ("entry_min", "stream_sweep")}

#: seconds a spawn's ranks may take before they are killed: the dry run
#: is short, so a hung first collective shows within DRY_TIMEOUT
DRY_TIMEOUT = 240.0
SPAWN_TIMEOUT = 600.0


def log(msg: str):
    print(msg, flush=True)


def hold(checks: dict, name: str, ok, detail: str = ""):
    """Record check `name` and raise if it failed."""
    checks[name] = bool(ok)
    if not ok:
        raise AssertionError(f"{name} failed{': ' + detail if detail else ''}")


def launched(launches: list) -> list:
    """render_jobs' launch counts of each rank, the kernels launched."""
    return [{k: v for k, v in n.items() if v} for n in launches]


def rank_counts(ranks: int) -> list[int]:
    """1, 2, 4, ... up to `ranks`, and `ranks` itself."""
    return sorted({1 << k for k in range(ranks.bit_length())} | {ranks})


def _dry_chunk(width: int, height: int, spp: int, ranks: int) -> int:
    """The work items per rank of a dry-run wavefront: the whole image
    shared evenly (dryrun_multichip's -(-total_q // n)), pixel-aligned."""
    return -(-width * height * spp // ranks // spp) * spp


# ---------------------------------------------------------------------------
# dry run


def _dry_run_rank(device, ranks: int):
    """Rank body of the dry run: the sharded batch pass, then the small
    wavefront and the living room twice through render_jobs.  Returns
    (the pass's record, render_jobs' results, every rank's device and
    whether it built the kernel library)."""
    import torch.distributed as dist

    from nori_tpu_torch import cuda_build

    scene = cornell_box(**DRY_BOX)
    sd, _ = prepare(scene, None, device)
    new_film, pass_fn, _ = parallel.make_sharded_sample_pass(
        scene, ranks * DRY_BATCH_PER_RANK, device=device)
    film = new_film() if dist.get_rank() == 0 else None
    film, rays = pass_fn(sd, film, SEED, 0)
    step = dict(rays=int(rays.sum()), rays_per_rank=rays.tolist(),
                finite=None if film is None
                else bool(torch.isfinite(film).all()))
    wave = dict(spp=DRY_WAVE["spp"], seed=SEED, n_lanes_dev=DRY_WAVE_LANES,
                chunk_dev=_dry_chunk(DRY_WAVE["width"], DRY_WAVE["height"],
                                     DRY_WAVE["spp"], ranks))
    room = dict(spp=DRY_ROOM["spp"], seed=SEED, n_lanes_dev=DRY_ROOM_LANES,
                chunk_dev=_dry_chunk(DRY_ROOM["width"], DRY_ROOM["height"],
                                     DRY_ROOM["spp"], ranks))
    jobs = [(cornell_box, DRY_WAVE, "wavefront", wave),
            (living_room, DRY_ROOM, "wavefront", room),
            (living_room, DRY_ROOM, "wavefront", room)]
    results = parallel.render_jobs(device, jobs)
    mine = dict(device=str(device), built=bool(cuda_build.build_log))
    ranks_info = [None] * dist.get_world_size()
    dist.all_gather_object(ranks_info, mine)
    return step, results, ranks_info


def dry_run(ranks: int, backend: str, device) -> dict:
    """dryrun_multichip's assertion set at `ranks` ranks of `backend`,
    rank r on parallel.rank_device(device, r), against one device (rank
    0's) in this process; returns its record."""
    t0 = time.time()
    checks = {}
    step, results, ranks_info = parallel.spawn(
        _dry_run_rank, ranks, ranks, backend=backend, device=device,
        timeout=DRY_TIMEOUT)
    (w_img, w_st, _), (a, st_a, launches), (b, _, _) = results
    log(f"dry run: {ranks} rank(s) on {[r['device'] for r in ranks_info]}; "
        f"kernel library built by ranks "
        f"{[r for r, i in enumerate(ranks_info) if i['built']]}")
    hold(checks, "batch pass film finite", step["finite"])
    log(f"dry run: one sharded batch pass OK (rays={step['rays']})")
    hold(checks, "sharded wavefront finite", np.isfinite(w_img).all())
    log(f"dry run: sharded wavefront OK (rays={w_st['rays']}, "
        f"mean={float(np.mean(w_img)):.4f})")

    home = parallel.rank_device(device, 0)
    chunk = _dry_chunk(DRY_ROOM["width"], DRY_ROOM["height"],
                       DRY_ROOM["spp"], ranks)
    ref, ref_st = render_wavefront(
        living_room(**DRY_ROOM), spp=DRY_ROOM["spp"], seed=SEED,
        n_lanes=DRY_ROOM_LANES, chunk=chunk, device=home)
    hold(checks, "living room finite", np.isfinite(a).all())
    hold(checks, "rays equal", st_a["rays"] == ref_st["rays"],
         f"{st_a['rays']} sharded, {ref_st['rays']} on one device")
    hold(checks, "sharded repeat bit-identical", np.array_equal(a, b))
    diff = np.abs(a - ref)
    hold(checks, "image bit-equal to one device", np.array_equal(a, ref),
         f"max |diff| {float(diff.max()):.3e}")
    hold(checks, "rays on every rank", min(st_a["rays_per_dev"]) > 0,
         str(st_a["rays_per_dev"]))
    if home.type == "cuda":
        for r, n in enumerate(launches):
            hold(checks, f"K1, K2 on rank {r}",
                 all(n[k] > 0 for k in DRY_ROOM_KERNELS), str(n))
    log(f"dry run: living room OK: rays equal ({st_a['rays']}), sharded "
        f"repeat bit-identical, image bit-equal to one device, rays per "
        f"rank {st_a['rays_per_dev']}; steps {st_a['steps']}, wide "
        f"{st_a['wide_steps']}")
    return dict(
        ranks=ranks, backend=backend, rank_devices=ranks_info,
        reference_device=str(home), batch_pass=step,
        wavefront=dict(rays=w_st["rays"], mean=float(np.mean(w_img))),
        living_room=dict(rays=st_a["rays"], reference_rays=ref_st["rays"],
                         rays_per_rank=st_a["rays_per_dev"],
                         steps=st_a["steps"], wide_steps=st_a["wide_steps"],
                         chunk_dev=chunk, sha1=_sha1(a),
                         max_abs_diff=float(diff.max()),
                         launches=launched(launches)),
        checks=checks, seconds=time.time() - t0)


# ---------------------------------------------------------------------------
# full width


def _timed(results: list, checks: dict, label: str, ref_sha: str,
           ref_rays: int, kernels, warm: bool) -> dict:
    """The record of one rank count's renders of one case, the first a
    warm one if `warm`: each image's SHA-1 and rays held to the
    reference's, `kernels` launched on every rank in every render."""
    out = dict(seconds=[], mrays_per_sec=[], sha1=[], rays=[], launches=[])
    if warm:
        out["warm_seconds"] = results[0][1]["seconds"]
    for i, (img, st, launches) in enumerate(results):
        sha = _sha1(img)
        hold(checks, f"{label} render {i}: SHA-1 and rays equal",
             sha == ref_sha and st["rays"] == ref_rays,
             f"{sha} / {st['rays']} vs {ref_sha} / {ref_rays}")
        for r, n in enumerate(launches):
            hold(checks, f"{label} render {i}: {', '.join(kernels)} on "
                 f"rank {r}", all(n[k] > 0 for k in kernels), str(n))
        out["sha1"].append(sha)
        out["rays"].append(st["rays"])
        if i or not warm:
            out["seconds"].append(st["seconds"])
            out["mrays_per_sec"].append(st["mrays_per_sec"])
            out["launches"].append(launched(launches))
    st = results[-1][1]
    if "rays_per_dev" in st:
        out.update(rays_per_rank=st["rays_per_dev"], steps=st["steps"],
                   wide_steps=st["wide_steps"])
    log(f"  {label}: "
        + (f"warm {out['warm_seconds']:.2f} s, " if warm else "")
        + "measured " + ", ".join(
            f"{s:.2f} s ({m:.2f} Mrays/s)"
            for s, m in zip(out["seconds"], out["mrays_per_sec"]))
        + (f"; rays per rank {out['rays_per_rank']}, steps "
           f"{out['steps']}, wide {out['wide_steps']}"
           if "rays_per_rank" in out else ""))
    return out


def living_room_phase(ranks: int, backend: str, device) -> dict:
    """FULL through render_sharded_wavefront at every rank_counts(ranks),
    against render_wavefront(chunk=FULL_CHUNK) on rank 0's device."""
    checks = {}
    home = parallel.rank_device(device, 0)
    img, st = render_wavefront(living_room(**FULL), seed=SEED,
                               n_lanes=FULL_LANES, chunk=FULL_CHUNK,
                               device=home)
    ref = dict(sha1=_sha1(img), rays=st["rays"], seconds=st["seconds"],
               mrays_per_sec=st["mrays_per_sec"], steps=st["steps"])
    log(f"living room on {home}: {st['seconds']:.2f} s, rays {st['rays']}, "
        f"{st['mrays_per_sec']:.2f} Mrays/s, SHA-1 {ref['sha1']}")
    del img
    job = (living_room, FULL, "wavefront",
           dict(seed=SEED, n_lanes_dev=FULL_LANES, chunk_dev=FULL_CHUNK))
    out = {}
    for n in rank_counts(ranks):
        results = parallel.spawn(parallel.render_jobs, n,
                                 [job] * (1 + MEASURED), backend=backend,
                                 device=device, timeout=SPAWN_TIMEOUT)
        out[str(n)] = _timed(results, checks, f"{n} rank(s)", ref["sha1"],
                             ref["rays"], ROOM_KERNELS, warm=True)
    return dict(reference=ref, reference_device=str(home), ranks=out,
                lanes_per_rank=FULL_LANES, chunk_per_rank=FULL_CHUNK,
                checks=checks)


def _ajax_kwargs(name: str) -> dict:
    integrator, spp = AJAX[name]
    return dict(width=AJAX_SIZE, height=AJAX_SIZE, spp=spp,
                integrator=integrator)


def ajax_phase(ranks: int, backend: str, device) -> dict:
    """Both ajax renders at both AJAX_BATCHES through render_sharded at
    every rank_counts(ranks), against render(batch=...) on rank 0's
    device; one spawn per rank count, its first render a warm one."""
    checks = {}
    home = parallel.rank_device(device, 0)
    cases = [(name, b) for name in AJAX for b in AJAX_BATCHES]
    refs = {}
    for name, b in cases:
        img, st = render(ajax_scene(**_ajax_kwargs(name)), seed=SEED,
                         batch=b, device=home)
        refs[name, b] = dict(sha1=_sha1(img), rays=st["rays"],
                             seconds=st["seconds"],
                             mrays_per_sec=st["mrays_per_sec"])
        log(f"{name} at batch {b} on {home}: {st['seconds']:.2f} s, rays "
            f"{st['rays']}, SHA-1 {refs[name, b]['sha1']}")
    jobs = [(ajax_scene, _ajax_kwargs(name), "batch",
             dict(seed=SEED, batch=b)) for name, b in cases]
    out = {f"{name} batch {b}": dict(reference=refs[name, b], ranks={})
           for name, b in cases}
    for n in rank_counts(ranks):
        # a warm render of the first case, then each case MEASURED times
        results = parallel.spawn(
            parallel.render_jobs, n,
            jobs[:1] + [j for j in jobs for _ in range(MEASURED)],
            backend=backend, device=device, timeout=SPAWN_TIMEOUT)
        for i, (name, b) in enumerate(cases):
            ref = refs[name, b]
            mine = results[1 + i * MEASURED:1 + (i + 1) * MEASURED]
            out[f"{name} batch {b}"]["ranks"][str(n)] = _timed(
                results[:1] + mine if i == 0 else mine, checks,
                f"{name} batch {b}, {n} rank(s)", ref["sha1"], ref["rays"],
                AJAX_KERNELS[AJAX[name][0]], warm=i == 0)
    return dict(cases=out, reference_device=str(home), checks=checks)


# ---------------------------------------------------------------------------
# off card 0


def _chip_smoke():
    """chip_smoke.py of this checkout (its check inputs)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def parity_check(home, other) -> dict:
    """chip_smoke.PARITY's living room on `other` against `home`: the
    same image bits and rays."""
    cfg = _chip_smoke().PARITY
    out = {}
    for d in (home, other):
        scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                            detail=cfg["detail"])
        out[d] = render_wavefront(scene, seed=SEED, n_lanes=cfg["n_lanes"],
                                  device=d)
    (a, st_a), (b, st_b) = out[home], out[other]
    equal = np.array_equal(a, b) and st_a["rays"] == st_b["rays"]
    log(f"parity living room on {other}: rays {st_b['rays']} vs "
        f"{st_a['rays']} on {home}, image "
        f"{'bit-equal' if equal else 'differs'}")
    return dict(equal=equal, rays=st_b["rays"], home_rays=st_a["rays"],
                sha1=_sha1(b), home_sha1=_sha1(a))


def room_inputs(home, card):
    """chip_smoke.py's living-room check inputs (FULL's scene,
    CHECK_LANES camera/bounce rays and their shadow rays) made on
    `home`; returns (scene data on `card`, rays, shadow on `card`)."""
    cs = _chip_smoke()
    cfg = cs.FULL
    scene = living_room(cfg["width"], cfg["height"], cfg["spp"],
                        detail=cfg["detail"])
    rays, shadow = cs.wavefront_rays(scene, scene.compile(home), home,
                                     cs.CHECK_LANES)
    sd = living_room(cfg["width"], cfg["height"], cfg["spp"],
                     detail=cfg["detail"]).compile(card)
    return sd, rays.to(card), shadow.to(card)


def ajax_inputs(home, card):
    """chip_smoke.py's ajax check inputs (AJAX_CHECK_LANES camera rays
    spread over the image and their shadow rays) made on `home`; returns
    (scene data on `card`, rays, shadow on `card`)."""
    cs = _chip_smoke()

    def scene():
        return cs.ajax_scene(cs.AJAX_SIZE, cs.AJAX_SIZE, 4, "whitted")

    s = scene()
    n = cs.AJAX_CHECK_LANES
    w, h = s.camera.output_size
    q = torch.arange(n, dtype=torch.int64, device=home) * (
        w * h * s.sampler.sample_count // n)
    rays, shadow = cs.ajax_rays(s, s.compile(home), home, q)
    return scene().compile(card), rays.to(card), shadow.to(card)


def _sliced(plain, bounds, rays):
    """A key kernel's plain version over slices of 65,536 rays (its
    temporaries grow with rays x boxes)."""
    parts = [plain(bounds, rays[:, c:c + 65536].contiguous())
             for c in range(0, rays.shape[1], 65536)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def key_check(kernel: str, bounds, rays) -> int:
    """K1 ("entry_min") or K3 ("lane_keys") on rays' card against its
    plain version, bit for bit; returns the entries compared."""
    from nori_tpu_torch.accel import sweep

    fn, plain = ((sweep.entry_min, sweep.entry_min_plain)
                 if kernel == "entry_min"
                 else (sweep.lane_keys, sweep.lane_keys_plain))
    got, ref = fn(bounds, rays), _sliced(plain, bounds, rays)
    got, ref = ((got,), (ref,)) if torch.is_tensor(got) else (got, ref)
    bad = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
              for g, r in zip(got, ref))
    if bad:
        raise AssertionError(f"{kernel} on {rays.device} differs from its "
                             f"plain version in {bad} entries")
    return sum(g.numel() for g in got)


def sweep_check(kernel: str, sd, rays, any_hit: bool) -> int:
    """K2 ("resident_sweep") or K5 ("stream_sweep") on the BW operand
    on rays' card against its plain version: equal hits, and for closest
    hits equal triangles and t bits (chip_smoke.compare_sweep); returns
    the hits."""
    from nori_tpu_torch.accel import sweep

    keys, bits = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    if kernel == "resident_sweep":
        got = sweep.resident_sweep(sd.tri_bw, keys, bits, rays, any_hit)
        ref = sweep.resident_sweep_plain(sd.tri_bw, rays, any_hit)
    else:
        got = sweep.stream_sweep(sd.tri_bw, keys, bits, rays, any_hit,
                                 sub_boxes=sd.tri_sub_boxes)
        ref = sweep.stream_sweep_plain(sd.tri_bw, rays, any_hit)
    _chip_smoke().compare_sweep(
        f"{kernel} {'any-hit' if any_hit else 'closest'} on {rays.device}",
        got, ref, any_hit, bits=True)
    return int((got[1] >= 0).sum())


def off_card_phase(ranks: int, backend: str, device) -> dict:
    """The parity render on cuda:1 and K1, K2, K3 and K5 on the last
    rank's card, from this process with its current device cuda:0."""
    from nori_tpu_torch.wavefront import _coarsen_bounds, key_coarsen

    if torch.device(device).type != "cuda" or ranks < 2:
        raise ValueError("the off-card0 phase needs at least two cards")
    checks = {}
    home, other = torch.device("cuda", 0), torch.device("cuda", 1)
    card = torch.device("cuda", ranks - 1)
    hold(checks, "current device is cuda:0",
         torch.cuda.current_device() == 0)
    out = dict(current_device=torch.cuda.current_device(),
               parity_device=str(other), kernel_device=str(card))
    out["parity"] = parity_check(home, other)
    hold(checks, f"parity living room on {other} bit-equal to {home}",
         out["parity"]["equal"])
    sd, rays, shadow = room_inputs(home, card)
    tb = sd.tri_tile_bounds
    kb = _coarsen_bounds(tb, key_coarsen(sd.tri_packed.shape[0],
                                         tb.shape[0]))
    runs = {"K1 closest": lambda: key_check("entry_min", tb, rays),
            "K1 shadow": lambda: key_check("entry_min", tb, shadow),
            "K2 closest": lambda: sweep_check("resident_sweep", sd, rays,
                                              False),
            "K2 any-hit": lambda: sweep_check("resident_sweep", sd, shadow,
                                              True),
            "K3": lambda: key_check("lane_keys", kb, rays)}
    for label, fn in runs.items():
        out[label] = fn()  # raises on a difference
        checks[f"{label} on {card} equals its plain version"] = True
        log(f"{label} on {card}: equal to its plain version ({out[label]})")
    del sd, rays, shadow
    sd, rays, shadow = ajax_inputs(home, card)
    for label, r, any_hit in (("K5 closest", rays, False),
                              ("K5 any-hit", shadow, True)):
        out[label] = sweep_check("stream_sweep", sd, r, any_hit)
        checks[f"{label} on {card} equals its plain version"] = True
        log(f"{label} on {card}: equal to its plain version ({out[label]})")
    hold(checks, "current device still cuda:0",
         torch.cuda.current_device() == 0)
    out["checks"] = checks
    return out


PHASES = {"dry-run": dry_run, "living-room": living_room_phase,
          "ajax": ajax_phase, "off-card0": off_card_phase}


def host_record(ranks: int, backend: str, device: torch.device) -> dict:
    """The cards, NCCL and host a record was measured on."""
    out = dict(ranks=ranks, backend=backend, device=str(device),
               torch=torch.__version__, cuda=torch.version.cuda,
               cpu_count=os.cpu_count(),
               env={k: v for k, v in os.environ.items()
                    if k.startswith(("NCCL_", "TORCH_NCCL_"))
                    or k == "CUDA_VISIBLE_DEVICES"})
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        out.update(cards=smi.stdout.strip().splitlines(),
                   nccl=".".join(map(str, torch.cuda.nccl.version())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multicard")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: rank r on cuda:r (no fallback); cpu: only "
                         "with --backend gloo")
    ap.add_argument("--out", default=OUT_JSON)
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error("--ranks must be at least 1")
    if (args.backend, args.device) == ("nccl", "cpu"):
        raise ValueError("nccl renders on cards: --device cpu needs "
                         "--backend gloo")
    if args.device == "cuda":
        if args.backend != "nccl":
            raise ValueError("on cards the ranks join over nccl")
        if args.ranks > torch.cuda.device_count():
            raise RuntimeError(
                f"{args.ranks} ranks need {args.ranks} cards, one each; "
                f"this host has {torch.cuda.device_count()}")
    # the full-width phases and the off-card one need cards
    phases = list(PHASES) if args.device == "cuda" else ["dry-run"]
    device = torch.device(args.device)
    record = host_record(args.ranks, args.backend, device)
    record["phases"] = {}
    log(json.dumps({k: v for k, v in record.items() if k != "phases"}))
    t0, name = time.time(), None
    try:
        for name in phases:
            log(f"== phase {name}")
            t = time.time()
            record["phases"][name] = PHASES[name](args.ranks, args.backend,
                                                  args.device)
            log(f"== phase {name}: {time.time() - t:.1f} s")
        record["ok"] = True
    except Exception:
        log(f"multicard: FAILED in phase {name}")
        traceback.print_exc()
        record.update(ok=False, failed_phase=name,
                      error=traceback.format_exc().strip().splitlines()[-1])
    record["seconds"] = time.time() - t0
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    log(f"multicard: {'OK' if record['ok'] else 'FAILED'} in "
        f"{record['seconds']:.1f} s -> {args.out}")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
