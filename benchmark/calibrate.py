"""Readings the limits of `correct` are set from, on the card:

    python3 -m benchmark.calibrate --workload <name> --seeds 12 \
        --control-seeds 3 --images <n> --base <n> [--out FILE]

In one process (set-up once), for each seed a run of --images window
images is mirrored: the same render seeds, blocks and choice of blocks
as a run with that seed and that many images.  For the first --seeds
seeds the program renders those images through the window's own entry;
for the first --control-seeds the control takes the program's place (the
plain reference with its path state in bfloat16).  Each side is judged
by the run's own comparison, giving the numbers of `check.NUMBERS`.  The
benchmark's own runs never run the control.  Prints one JSON line per
seed and a summary; writes them to --out as well.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--base", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import check, manifest as mf, port
    from benchmark.reference.render import Reference

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("unavailable: no CUDA card", file=sys.stderr)
        return 3
    man = mf.load()
    wl = mf.workload(man, args.workload)
    traffic = mf.cell(args.workload)
    cfg = mf.config(man, wl["config"])
    desc = mf.scene_builder(wl["config"])(cfg)
    w, h = desc.camera.width, desc.camera.height
    size = int(traffic["check"]["block"])
    per_image = int(traffic["check"]["blocks_per_image"])
    cap = int(traffic["check"]["max_images"])
    scene = port.build_scene(desc, traffic["integrator"], int(traffic["spp"]))
    port.compile_scene(scene)
    ref = Reference(desc, traffic, device)
    ctl = Reference(desc, traffic, device, lowp=True)
    n = args.images
    rows = []
    for k in range(max(args.seeds, args.control_seeds)):
        run_seed = args.base + k
        seeds = {i: check.mix_seed(run_seed, i) for i in range(n)}
        corners = {i: check.block_corners(run_seed, i, w, h, size, per_image)
                   for i in range(n)}
        pairs = check.choose(run_seed, n, per_image, cap)
        row = {"seed": run_seed, "images": n}
        if k < args.seeds:
            t0 = time.perf_counter()
            blocks = {}
            for i in sorted({i for i, _ in pairs}):
                img, _ = port.render_image(scene, traffic, seeds[i], device)
                blocks[i] = [img[y:y + size, x:x + size].copy()
                             for x, y in corners[i]]
            row["render_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cmp = check.compare(ref, blocks, seeds, corners, pairs, size)
            row["reference_s"] = time.perf_counter() - t0
            row["program"] = check.numbers(cmp)
        if k < args.control_seeds:
            t0 = time.perf_counter()
            low = ctl.blocks([(seeds[i], *corners[i][b]) for i, b in pairs],
                             size)
            blocks = {i: [None] * per_image for i, _ in pairs}
            for (i, b), blk in zip(pairs, low):
                blocks[i][b] = blk
            row["control"] = check.numbers(
                check.compare(ref, blocks, seeds, corners, pairs, size))
            row["control_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "images": n,
               "limits": traffic["limits"]}
    for side in ("program", "control"):
        vals = [r[side] for r in rows if side in r]
        summary[side] = {m: {"max": max(v[m] for v in vals),
                             "min": min(v[m] for v in vals)}
                         for m in check.NUMBERS} if vals else None
    if device.type == "cuda":
        summary["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
