"""Benchmark of nori_tpu_torch on one CUDA card: rendering throughput
on the flagship workloads.  The port's counterpart of the repository's
`bench.py`, run as

    python bench_torch.py [--device cuda] [--scenes DIR]

It prints JSON records, and the LAST line printed is always a complete,
valid record, whatever stops the run (the rules of bench.py:11-24):

  * a wall-clock budget (env BENCH_TIME_BUDGET, default 480 s) is
    counted from process start;
  * the headline living-room row runs first and the record is flushed
    the moment it completes; the whole record is flushed again after
    every later row, so later rows only ever add to it;
  * every later row is guarded against the time left (its estimate
    learns the set-up cost from the rows already measured), and the
    rows skipped are listed in "skipped", beside those whose reference
    XML is absent.

Rows, each a warm render at seed 0 and then two measured renders at
seed 1 (single renders spread 15-20% between calls, so each row reports
both and their median):

  living_room   scenes_builtin.living_room(1280, 720, spp=32, detail=5),
                path_mis through the persistent wavefront, 524,288
                lanes.  The headline.
  cbox_mis      the reference pa5 cbox XML when --scenes holds it, else
                the built-in cornell_box(800, 600) at 32 spp, 131,072
                lanes.
  table_mis     the reference pa5 XMLs, only when --scenes holds them.
  veach_mis
  ajax_normals  the reference XMLs when --scenes holds them, else the
  ajax_rough    ajax composition (ajax_scene: their camera, integrator
                and emitter around the procedural 541,660-triangle
                stand-in for the absent scan), normals at 4 spp and
                whitted at 16 spp through the batch driver; the
                streamed layout, the only rows that sweep with K5.
  kernel        profiling.kernel_report on the living room.

Each row holds bench.py's fields (`driver`, `mrays_per_sec`,
`samples_per_sec`, `seconds`, `rays`, `spp`, `triangles`,
`mean_radiance`, `occupancy`, `steps`, `row_seconds`), both measured
renders' seconds, Mrays/s and image SHA-1 (equal: the render is
deterministic), and the kernel launches the row made, read from the
launch counters of accel.sweep's wrappers.  The record names the card
(torch.cuda.get_device_name and nvidia-smi's power.limit, null without
that tool).  Without a CUDA device, and unless given `--device cpu`,
it prints an "unavailable" record as its last line and exits 2: it
never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

#: the budget counts from here, which `python bench_torch.py` reaches
#: at process start
T0 = time.time()

#: the headline row (BASELINE.md's living-room workload)
ROOM = dict(width=1280, height=720, spp=32, detail=5)
ROOM_LANES = 524288
#: the built-in Cornell box row
CBOX = dict(width=800, height=600, spp=32)
LANES = 131072
#: reference scenes, relative to --scenes (the Nori reference tree)
REF_CBOX = "pa5/cbox/cbox_mis.xml"
REF_TABLE = "pa5/table/table_mis.xml"
REF_AJAX_N = "pa2/ajax-normals.xml"
REF_AJAX_R = "pa5/ajax/ajax-rough.xml"
REF_VEACH = "pa5/veach_mi/veach_mis.xml"
#: the ajax rows: (reference XML, integrator, spp, seconds one render is
#: expected to take on the card, for the guard)
AJAX_ROWS = {
    "ajax_normals": (REF_AJAX_N, "normals", 4, 1.0),
    "ajax_rough": (REF_AJAX_R, "whitted", 16, 3.0),
}

#: the ajax composition: camera of scenes/pa2/ajax-normals.xml (fov 30,
#: 768x768), the stand-in bust (microfacet alpha 0.2, kd 0.3) and an
#: emissive quad standing in for scenes/pa5/ajax/light.obj: y 6.3-33.7,
#: 50 degrees around the bust from the camera, facing the bust
AJAX_ORIGIN = [-65.6055, 47.5762, 24.3583]
AJAX_TARGET = [-64.8161, 47.2211, 23.8576]
AJAX_UP = [0.299858, 0.934836, -0.190177]
AJAX_LIGHT = ([-58.437, 6.3, 35.786], [-58.437, 33.7, 35.786],
              [-38.614, 33.7, 38.436], [-38.614, 6.3, 38.436])
AJAX_RADIANCE = [8.0, 8.0, 8.0]
AJAX_SIZE = 768

#: the smallest set-up cost a later row's guard assumes, seconds
MIN_SETUP_S = 10.0
#: margin a row must leave inside the budget, seconds
GUARD_MARGIN_S = 20.0


def ajax_scene(width: int, height: int, spp: int, integrator: str,
               n_lat: int = 512, n_lon: int = 530):
    """The ajax composition (see AJAX_*), with the stand-in bust at
    n_lat x n_lon."""
    from nori_tpu_torch import scenes_builtin as sb
    from nori_tpu_torch.core.transform import Transform
    from nori_tpu_torch.props import PropertyList
    from nori_tpu_torch.registry import create_instance
    from nori_tpu_torch.scene import Scene

    md = sb.ajax_standin_meshdata(n_lat=n_lat, n_lon=n_lon)
    scene = Scene(PropertyList())
    scene.add_child(sb._mesh_obj(
        md.positions, md.faces,
        sb._bsdf("microfacet", alpha=0.2, kd=[0.3, 0.3, 0.3]), name="ajax"))
    v, f = sb._quad(*AJAX_LIGHT)
    scene.add_child(sb._mesh_obj(
        v, f, sb._bsdf("diffuse", albedo=[0.0, 0.0, 0.0]),
        emitter=sb._area_light(AJAX_RADIANCE), name="light"))
    cam_pl = PropertyList()
    cam_pl.set_integer("width", width)
    cam_pl.set_integer("height", height)
    cam_pl.set_float("fov", 30.0)
    cam_pl.set_transform("toWorld", Transform.lookat(AJAX_ORIGIN,
                                                     AJAX_TARGET, AJAX_UP))
    cam = create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)
    samp_pl = PropertyList()
    samp_pl.set_integer("sampleCount", spp)
    scene.add_child(create_instance("independent", samp_pl))
    scene.add_child(create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


def card(device: torch.device) -> dict:
    """The device a record was measured on: its name and, for a CUDA
    card, the power limit nvidia-smi reports (null without the tool)."""
    out = {"name": "cpu", "power_limit": None, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if device.type != "cuda":
        return out
    out["name"] = torch.cuda.get_device_name(device)
    if shutil.which("nvidia-smi"):
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True)
        except (OSError, subprocess.SubprocessError):
            return out
        index = device.index if device.index is not None else 0
        lines = smi.stdout.strip().splitlines()
        if index < len(lines):
            out["power_limit"] = lines[index].rsplit(",", 1)[-1].strip()
    return out


def _sha1(img) -> str:
    return hashlib.sha1(
        np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_scene(scene, spp: int, n_lanes: int = LANES, device=None) -> dict:
    """One row: a warm render at seed 0, then two measured renders at
    seed 1, dispatched as render_to_files does (the persistent wavefront
    for the path family, `render.render` otherwise) on `device`
    (default: the first CUDA device; device.resolve_device)."""
    from nori_tpu_torch.accel.sweep import launch_counters
    from nori_tpu_torch.device import resolve_device
    from nori_tpu_torch.integrators import PATH_FAMILY
    from nori_tpu_torch.render import render
    from nori_tpu_torch.wavefront import render_wavefront

    device = resolve_device(device)
    row_t0 = time.time()
    wavefront = scene.integrator.plugin_name in PATH_FAMILY

    def one(seed):
        if wavefront:
            return render_wavefront(scene, spp=spp, n_lanes=n_lanes,
                                    seed=seed, device=device)
        return render(scene, spp=spp, seed=seed, device=device)

    counters = launch_counters()
    _sync(device)
    for f in counters.values():
        f.launches = 0
    one(0)
    runs = [one(1) for _ in range(2)]
    _sync(device)
    launches = {k: f.launches for k, f in counters.items()}
    img, st = runs[0]
    tri_v0 = scene.compile_arrays()["tri_v0"]
    return {
        "driver": "wavefront" if wavefront else "batch",
        "mrays_per_sec": statistics.median(
            s["mrays_per_sec"] for _, s in runs),
        # rays counts traced rays only (shadow queries of a provably
        # zero contribution are culled before the sweep), so
        # samples_per_sec is the wall-clock figure to compare
        "samples_per_sec": statistics.median(
            s["samples_per_sec"] for _, s in runs),
        "seconds": statistics.median(s["seconds"] for _, s in runs),
        "rays": st["rays"],
        "spp": spp,
        "triangles": int(np.sum(tri_v0[:, 0] < 1e29)),
        "mean_radiance": float(np.mean(img)),
        "occupancy": st.get("occupancy", 0.0),
        "steps": st.get("steps", 0),
        "row_seconds": time.time() - row_t0,
        "seconds_each": [s["seconds"] for _, s in runs],
        "mrays_per_sec_each": [s["mrays_per_sec"] for _, s in runs],
        "rays_each": [s["rays"] for _, s in runs],
        "sha1": [_sha1(im) for im, _ in runs],
        "launches": launches,
    }


def _emit_unavailable(err: str) -> None:
    print(json.dumps({
        "metric": "mrays_per_sec_living_room",
        "value": 0.0,
        "unit": "Mrays/s (one card)",
        "error": f"CUDA device unavailable: {err}",
    }), flush=True)


class Record:
    """The bench record: flush() prints its current complete state as
    one JSON line.  Called after every row, so the last line printed is
    always valid whatever happens next."""

    def __init__(self, budget_s: float, t0: float, device: dict):
        self.budget_s = budget_s
        self.t0 = t0
        self.device = device
        self.breakdown = {}
        self.kernel = {}
        self.skipped = []
        self.partial = True
        self.setup_s = []

    def remaining(self) -> float:
        return self.budget_s - (time.time() - self.t0)

    def setup_est(self) -> float:
        """The set-up cost of a later row: the least seen so far (the
        headline row carries the kernels' build and the first scene)."""
        return min(self.setup_s, default=30.0)

    def observe(self, row: dict):
        self.setup_s.append(max(
            MIN_SETUP_S, row["row_seconds"] - 3 * row["seconds"]))

    def guard(self, name: str, render_s: float) -> bool:
        """Whether a row of three renders of render_s each fits the time
        left; if not, it is listed as skipped."""
        est = self.setup_est() + 3 * render_s
        if self.remaining() < est + GUARD_MARGIN_S:
            self.skipped.append({"row": name, "est_s": est,
                                 "remaining_s": self.remaining()})
            return False
        return True

    def flush(self):
        lr = self.breakdown.get("living_room", {})
        rec = {
            "metric": "mrays_per_sec_living_room",
            "value": lr.get("mrays_per_sec", 0.0),
            "unit": "Mrays/s (one card)",
            "device": self.device,
            "elapsed_s": time.time() - self.t0,
            "budget_s": self.budget_s,
            "breakdown": self.breakdown,
            "kernel": self.kernel,
        }
        if self.skipped:
            rec["skipped"] = self.skipped
        if self.partial:
            rec["partial"] = True
        print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; no fallback)")
    ap.add_argument("--scenes", default=None,
                    help="root of the Nori reference scene tree (pa2/, "
                         "pa5/); rows that need one of its XMLs are "
                         "skipped without it")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        _emit_unavailable("torch.cuda.is_available() is False")
        return 2

    from nori_tpu_torch import load_from_xml
    from nori_tpu_torch.profiling import kernel_report
    from nori_tpu_torch.scenes_builtin import cornell_box, living_room

    rec = Record(float(os.environ.get("BENCH_TIME_BUDGET", "480")), T0,
                 card(device))

    def ref_xml(rel: str):
        if args.scenes is None:
            return None
        path = os.path.join(args.scenes, rel)
        return path if os.path.exists(path) else None

    def row(name: str, render_s: float, make, spp: int,
            n_lanes: int = LANES):
        if not rec.guard(name, render_s):
            return
        try:
            rec.breakdown[name] = bench_scene(make(), spp, n_lanes, device)
            rec.observe(rec.breakdown[name])
        except Exception as e:  # a row's failure must leave a record
            traceback.print_exc()
            rec.breakdown[name] = {"error": f"{type(e).__name__}: {e}"}
        rec.flush()

    def xml_row(name: str, rel: str, render_s: float, spp: int):
        path = ref_xml(rel)
        if path:
            row(name, render_s, lambda: load_from_xml(path), spp)
        else:
            rec.skipped.append({"row": name, "missing": rel})

    # the headline row first, flushed the moment it exists
    lr = living_room(**ROOM)
    rec.breakdown["living_room"] = bench_scene(lr, ROOM["spp"], ROOM_LANES,
                                               device)
    rec.observe(rec.breakdown["living_room"])
    rec.flush()

    path = ref_xml(REF_CBOX)
    if path:
        row("cbox_mis", 4.0, lambda: load_from_xml(path), 32)
    else:
        row("cbox_mis", 4.0, lambda: cornell_box(**CBOX), CBOX["spp"])

    xml_row("table_mis", REF_TABLE, 4.0, 32)

    for name, (rel, integrator, spp, render_s) in AJAX_ROWS.items():
        path = ref_xml(rel)
        if path:
            row(name, render_s, lambda: load_from_xml(path), spp)
        else:
            row(name, render_s,
                lambda: ajax_scene(AJAX_SIZE, AJAX_SIZE, spp, integrator), spp)

    xml_row("veach_mis", REF_VEACH, 3.0, 16)

    if rec.guard("kernel_living_room", 10.0):
        try:
            rec.kernel["living_room"] = kernel_report(lr, device=device)
        except Exception as e:  # diagnostics only
            traceback.print_exc()
            rec.kernel["living_room"] = {"error": f"{type(e).__name__}: {e}"}
        rec.flush()

    rec.partial = False
    rec.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
