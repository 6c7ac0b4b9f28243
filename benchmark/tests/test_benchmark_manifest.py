"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration and metric it names is found by name; a cell is added by
adding files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = mf.ROOT


@pytest.fixture(scope="module")
def man():
    return mf.load()


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for word in man["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entries(man):
    names = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    assert {"samples_per_s", "setup_s"} <= e2e
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_name_is_found(man):
    cells = {w["name"] for w in man["workloads"]}
    for w in man["workloads"]:
        cell = mf.cell(w["name"])
        assert cell["traffic"] == w["traffic"]
        assert set(cell["limits"]) == {"err_p50", "err_p90", "img_p50_max"}
        assert 1 <= cell["warm_spp"] <= cell["spp"]
        assert callable(mf.scene_builder(w["config"]))
        assert mf.config(man, w["config"])["name"] == w["config"]
        groups = [mf.metrics_for(man, w["name"], t) for t in (0, 1)]
        assert {"setup_s", "samples_per_s"} <= {m["name"] for m in groups[0]}
        assert groups[1]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(mf.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a configuration file and a
    per-layer metric by new files and manifest entries; the harness
    finds them without any edit to its code."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = mf.load()
    man["configs"].append({**man["configs"][2], "name": "cbox_small",
                           "file": "benchmark/configs/cbox_small.json"})
    man["workloads"].append({"name": "cbox_small.normals",
                             "config": "cbox_small",
                             "traffic": "normals.1spp", "chips": 1,
                             "why": "a cell added by files"})
    man["per_layer"].append({"name": "images_per_window", "unit": "images",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "samples_per_s",
                             "workloads": ["cbox_small.normals"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cfg = json.loads((ROOT / "benchmark/configs/cbox.json").read_text())
    cfg.update(name="cbox_small", width=24, height=16)
    (tmp_path / "benchmark/configs/cbox_small.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark/configs/cbox_small.py").write_text(
        "from benchmark.configs.cbox import build  # noqa: F401\n")
    (tmp_path / "benchmark/cells/cbox_small.normals.json").write_text(
        json.dumps({"traffic": "normals.1spp", "integrator": "normals",
                    "spp": 1, "batch": 4096,
                    "check": {"block": 8, "blocks_per_image": 1,
                              "max_images": 2},
                    "trace_seconds": 0.0,
                    "limits": {"err_p50": 1e-4, "err_p90": 1e-3,
                               "img_p50_max": 1e-3}}))
    (tmp_path / "benchmark/metrics/images_per_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['images']))\n")
    code = textwrap.dedent("""
        import json, torch
        torch.set_num_threads(2)
        from benchmark.run import run_cell
        r = run_cell("cbox_small.normals", 3, 0.0, True, device="cpu")
        print(json.dumps(r))
    """)
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["images_per_window"]["value"] == 1.0
