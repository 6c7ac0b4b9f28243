"""BENCHMARK.json and the files it names, found by name.

  cells/<workload>.json   a cell's traffic: integrator, spp, the
                          driver's width, the check's blocks, its limits
  configs/<config>.json   a configuration's sizes (BENCHMARK.json's
                          `file`), with configs/<config>.py beside it,
                          whose build(cfg) makes the scene description
  metrics/<metric>.py     a metric's reader, read(ctx)

Adding a cell, a configuration or a per-layer metric is adding those
files and an entry in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> dict:
    with open(Path(here) / "cells" / f"{name}.json") as f:
        return json.load(f)


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / config_entry(manifest, name)["file"]) as f:
        return json.load(f)


def scene_builder(name: str):
    return importlib.import_module(f"benchmark.configs.{name}").build


def reader(metric: str):
    return importlib.import_module(f"benchmark.metrics.{metric}").read


def metrics_for(manifest: dict, workload_name: str, traced: bool) -> list:
    """The metric entries a run of the workload reports: the end-to-end
    ones untraced, the per-layer ones traced, each where its
    `workloads` (if any) lists the cell."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload_name in m["workloads"]]
