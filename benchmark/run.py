"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One client renders one image after
another (a closed loop: a render node working through a queue of
frames) through the entry the integrator takes in the port
(`render_wavefront` for the path family, `render` otherwise); image i
renders with a seed made from --seed and i.  Set-up (imports, the scene,
its compile, the kernel library, one warm image at the cell's
`warm_spp`) comes first; the window then renders whole images back to back and closes at the first
image boundary at or after --seconds.  With --trace 1 the window is
followed by a section under torch.profiler (device activity only) for
the per-layer metrics, and by one warm-size image under the profiler's
host activity too, whose idle gaps the breakdown credits to what the
host was doing.
Then the plain reference renders blocks of the window's images again
and the run is `correct` when they agree within the cell's limits.

The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, [breakdown], check); the numbers
compared, beside their limits, are also the last lines of standard
error.  Without a CUDA card, or with fewer than the cell asks for, it
exits 3 and prints no result; it never runs on the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest as mf  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "nori_tpu")
#: a warm image's seed index, outside the window's (0, 1, ...)
WARM_INDEX = -1000


#: CPU thread pools that a run caps at one thread
POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def steady_host() -> None:
    """One thread for numpy's and torch's CPU pools, set before either
    is imported, so that a run is one process with few threads (on an
    H100's host it neither steadied nor slowed the window against the
    pools' defaults)."""
    for name in POOLS:
        os.environ[name] = "1"


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result object.  With trace, the
    kernels' launch counts of the traced section go to standard output
    first, as a line of their own.

    overrides: {"config": {...}, "cell": {...}} merged over the files
    (the CPU tests' tiny sizes)."""
    import torch

    from benchmark import check, port

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    overrides = overrides or {}
    man = mf.load()
    wl = mf.workload(man, workload)
    traffic = {**mf.cell(workload), **overrides.get("cell", {})}
    cfg = {**mf.config(man, wl["config"]), **overrides.get("config", {})}
    desc = mf.scene_builder(wl["config"])(cfg)
    spp = int(traffic["spp"])
    w, h = desc.camera.width, desc.camera.height
    samples_per_image = w * h * spp
    batched = not port.is_path_family(traffic["integrator"])

    # ---- set-up ---------------------------------------------------------
    scene = port.build_scene(desc, traffic["integrator"], spp)
    t0 = time.perf_counter()
    port.compile_scene(scene)
    compile_s = time.perf_counter() - t0
    # the warm image: every kernel and shape of the cell's images, at the
    # cell's lanes or batch, with fewer samples a pixel
    warm = {**traffic, "spp": int(traffic.get("warm_spp", spp))}
    port.render_image(scene, warm, check.mix_seed(seed, WARM_INDEX), device)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    size = int(traffic["check"]["block"])
    per_image = int(traffic["check"]["blocks_per_image"])

    def one_image(i):
        s = check.mix_seed(seed, i)
        img, st = port.render_image(scene, traffic, s, device)
        rec = {"seed": s, "seconds": float(st["seconds"]),
               "rays": int(st["rays"]), "steps": st.get("steps")}
        if batched:
            batch = int(traffic["batch"])
            rec["batches"] = math.ceil(samples_per_image / batch)
        return img, rec

    # ---- window -----------------------------------------------------------
    setup_s = time.perf_counter() - t_start
    images, blocks, corners = [], {}, {}
    tw = time.perf_counter()
    while True:
        i = len(images)
        img, rec = one_image(i)
        corners[i] = check.block_corners(seed, i, w, h, size, per_image)
        blocks[i] = [img[y:y + size, x:x + size].copy()
                     for x, y in corners[i]]
        images.append(rec)
        if time.perf_counter() - tw >= seconds:
            break
    window_s = time.perf_counter() - tw
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- traced section -------------------------------------------------
    tsum = None
    if trace:
        from benchmark import devtrace

        min_s = float(traffic.get("trace_seconds", 0.0))

        def section():
            recs, t1, k = [], time.perf_counter(), 0
            while not recs or time.perf_counter() - t1 < min_s:
                recs.append(one_image(len(images) + k)[1])
                k += 1
            return recs

        port.reset_launches()
        recs, tsum = devtrace.run_traced(section, device)
        tsum["images"] = recs
        print(json.dumps({"launches": port.sweep_launches()}), flush=True)
        _, gaps = devtrace.run_traced(
            lambda: port.render_image(
                scene, warm, check.mix_seed(seed, WARM_INDEX - 1), device),
            device, host=True)
        tsum["idle_gaps"] = gaps["idle_gaps"]

    ctx = {"samples_per_image": samples_per_image, "setup_s": setup_s,
           "compile_s": compile_s, "window_s": window_s, "images": images,
           "peak_bytes": peak, "trace": tsum}
    metrics = {}
    for m in mf.metrics_for(man, workload, trace):
        v = mf.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- correctness ----------------------------------------------------
    del scene
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from benchmark.reference.render import Reference

    t_ref = time.perf_counter()
    ref = Reference(desc, traffic, device)
    pairs = check.choose(seed, len(images), per_image,
                         int(traffic["check"]["max_images"]))
    seeds = {i: r["seed"] for i, r in enumerate(images)}
    cmp = check.compare(ref, blocks, seeds, corners, pairs, size)
    limits = traffic["limits"]
    values = check.numbers(cmp)
    result = {
        "correct": bool(check.judge(values, limits)),
        "attempted": len(images),
        "failed": check.failed_images(cmp, limits),
        "metrics": metrics,
        "device": {**device_info(device, int(wl["chips"])),
                   "memory_peak_bytes": int(peak)},
    }
    if tsum is not None:
        result["device"]["busy_s"] = tsum["busy_s"]
        result["device"]["window_s"] = tsum["window_s"]
        from benchmark.devtrace import top

        result["breakdown"] = {"device_ops": top(tsum["kernel_s"]),
                               "idle_gaps": top(tsum["idle_gaps"])}
    spent = {"setup": setup_s, "window": window_s,
             "trace": tsum["window_s"] if tsum else 0.0,
             "reference": time.perf_counter() - t_ref}
    print("seconds " + " ".join(f"{k} {v:.3f}" for k, v in spent.items()),
          file=sys.stderr)
    secs = [r["seconds"] for r in images]
    print(f"images {len(secs)} first_s {secs[0]:.4f} rest_median_s "
          f"{statistics.median(secs[1:] or secs):.4f} "
          f"checked {len(cmp['by_image'])}", file=sys.stderr)
    result["check"] = {k: {"value": values[k], "limit": limits[k]}
                       for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    steady_host()
    man = mf.load()
    chips = int(mf.workload(man, args.workload)["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("unavailable: torch.cuda.is_available() is False; this "
              "benchmark runs only on a CUDA card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"unavailable: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
