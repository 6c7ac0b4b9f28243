"""One cell's span run on the card: the program's spans and counters
read as the span metrics would read them in a `--trace 1` run.

    python3 -m benchmark.spanrun --workload <cell> --seed <n> --seconds <s>

from the root of a checkout.  Set-up and the window are
`benchmark.run`'s (spans off).  Then the span section renders the
window's images again, seed for seed, with spans on and no profiler,
for as long as the window took; then the profiled section of device
activity with spans on (benchmark.spantrace.profiled) renders images
over at least the cell's `trace_seconds`, continuing the seed index
after the window's; then the window's first three images once more
with spans off.  The last line of standard output is one JSON object:

  metrics    every per-layer metric BENCHMARK.json gives the cell, and
             the five span metrics (step_enqueue_ms,
             sync_wait_ms_per_batch, host_syncs_per_batch,
             prepare_ms_per_image, idle_unspanned_pct) where they read
             something
  breakdown  device_ops, idle_by_span (the profiled section's idle
             seconds by innermost span), device_by_span (its device
             seconds by the span that launched them) and span_self_s
             (the span section's host self seconds by span name), ten
             each
  counters   the span section's counters, and `agree`: its `steps`
             and `batches` beside the drivers' stats of its images
  cost       the drivers' seconds of each image in the window (spans
             off) and in the span section (spans on, the same seeds),
             `bit_equal`: whether every image of the span section equals
             the window's of its seed bit for bit, and `after_profiler_s`:
             the seconds of the three images after the profiled
             section

It checks no image against the reference (`benchmark.run` does).
Without a CUDA card it exits 3.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import time


def run_spans(workload: str, seed: int, seconds: float, device="cuda",
              overrides: dict | None = None) -> dict:
    """The span run of one cell; returns the result object.
    overrides: as benchmark.run.run_cell's (the tests' tiny sizes)."""
    import torch

    from benchmark import check, devtrace, port, spantrace
    from benchmark import manifest as mf
    from benchmark.run import WARM_INDEX, _sync

    t_start = time.perf_counter()
    sp = spantrace.recorder()
    if sp is None:
        raise RuntimeError("this checkout's nori_tpu_torch has no spans")
    device = torch.device(device)
    overrides = overrides or {}
    man = mf.load()
    wl = mf.workload(man, workload)
    traffic = {**mf.cell(workload), **overrides.get("cell", {})}
    cfg = {**mf.config(man, wl["config"]), **overrides.get("config", {})}
    desc = mf.scene_builder(wl["config"])(cfg)
    spp = int(traffic["spp"])
    samples_per_image = desc.camera.width * desc.camera.height * spp
    batched = not port.is_path_family(traffic["integrator"])

    scene = port.build_scene(desc, traffic["integrator"], spp)
    t0 = time.perf_counter()
    port.compile_scene(scene)
    compile_s = time.perf_counter() - t0
    warm = {**traffic, "spp": int(traffic.get("warm_spp", spp))}
    port.render_image(scene, warm, check.mix_seed(seed, WARM_INDEX), device)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def one_image(i):
        s = check.mix_seed(seed, i)
        img, st = port.render_image(scene, traffic, s, device)
        rec = {"seed": s, "seconds": float(st["seconds"]),
               "rays": int(st["rays"]), "steps": st.get("steps")}
        if batched:
            rec["batches"] = math.ceil(samples_per_image
                                       / int(traffic["batch"]))
        return img, rec

    def digest(img):
        return hashlib.sha1(img.tobytes()).hexdigest()

    # ---- window, spans off --------------------------------------------
    setup_s = time.perf_counter() - t_start
    images, hashes = [], []
    tw = time.perf_counter()
    while True:
        img, rec = one_image(len(images))
        hashes.append(digest(img))
        images.append(rec)
        if time.perf_counter() - tw >= seconds:
            break
    window_s = time.perf_counter() - tw
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- the window's seeds again with spans on -------------------------
    def again(k):
        img, rec = one_image(k % len(images))
        rec["equal"] = digest(img) == hashes[k % len(images)]
        return rec

    span = spantrace.span_section(again, window_s)

    # ---- profiled section with spans on -------------------------------
    min_s = float(traffic.get("trace_seconds", 0.0))

    def section():
        recs, t1 = [], time.perf_counter()
        while not recs or time.perf_counter() - t1 < min_s:
            recs.append(one_image(len(images) + len(recs))[1])
        return recs

    recs, tsum = spantrace.profiled(section, device)
    tsum["images"] = recs
    after = [one_image(k % len(images))[1]["seconds"] for k in range(3)]

    ctx = {"samples_per_image": samples_per_image, "setup_s": setup_s,
           "compile_s": compile_s, "window_s": window_s, "images": images,
           "peak_bytes": peak, "trace": tsum, "spans": span}
    names = [m["name"] for m in mf.metrics_for(man, workload, True)]
    names += ["step_enqueue_ms", "sync_wait_ms_per_batch",
              "host_syncs_per_batch", "prepare_ms_per_image",
              "idle_unspanned_pct"]
    metrics = {}
    for name in names:
        v = mf.reader(name)(ctx)
        if v is not None:
            metrics[name] = v
    counters = span["counters"]
    agree = {"steps": [counters.get("steps", 0),
                       sum(r.get("steps") or 0 for r in span["images"])],
             "batches": [counters.get("batches", 0),
                         sum(r.get("batches") or 0 for r in span["images"])]}
    return {
        "workload": workload, "seed": seed, "metrics": metrics,
        "breakdown": {
            "device_ops": devtrace.top(tsum["kernel_s"]),
            "idle_by_span": devtrace.top(tsum.get("idle_by_span", {})),
            "device_by_span": devtrace.top(tsum.get("device_by_span", {})),
            "span_self_s": devtrace.top(
                spantrace.self_seconds(span["records"]))},
        "counters": {**counters, "agree": agree},
        "cost": {"window_s": [r["seconds"] for r in images],
                 "span_s": [r["seconds"] for r in span["images"]],
                 "bit_equal": all(r["equal"] for r in span["images"]),
                 "after_profiler_s": after},
        "sections": {"window_images": len(images),
                     "profiled_images": len(recs),
                     "span_images": len(span["images"]),
                     "profiled_records": len(tsum.get("records", [])),
                     "span_records": len(span["records"]),
                     "busy_s": tsum["busy_s"],
                     "profiled_window_s": tsum["window_s"],
                     "idle_s": tsum.get("idle_s"),
                     "idle_unspanned_s": tsum.get("idle_unspanned_s")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spanrun",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from benchmark.run import steady_host

    steady_host()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("unavailable: torch.cuda.is_available() is False; the span "
              "run measures only on a CUDA card", file=sys.stderr)
        return 3
    res = run_spans(args.workload, args.seed, args.seconds)
    res["device"] = {"kind": torch.cuda.get_device_name(0)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
