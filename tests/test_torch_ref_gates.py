"""The repair of the full-size RMSE gate's reference and the port's runner
of the reference's statistical fixtures, on the CPU:

* tools/reference_rows.py's row-chunked checkpoint resume (the JAX
  package) gives the rows of an uncut JAX render in other chunks, up to
  the order of the film's sums (rtol 1e-5, atol 1e-6);
* the port's resume of the same rows (`rmse_gate.render_rows`) passes
  the exact gate (RMSE < 1e-3, < 1% of pixels off by more than 1e-3)
  against those JAX rows, with equal ray counts;
* `rmse_gate`'s composite reference: the npz's rows, the EXR's elsewhere;
* the port's `ref_gates.run_fixture` against scripts/ref_gates.py's on
  one furnace XML (equal `ok`, `passed`, `total`), the furnace exemption
  from --scale, and the record of missing fixtures.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from nori_tpu import config as jax_config
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf
from nori_tpu.testing import ttest as jax_ttest

from nori_tpu_torch import config
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch.bitmap import write_exr
from nori_tpu_torch.scripts import ref_gates
from nori_tpu_torch.scripts import rmse_gate
from nori_tpu_torch.testing import ttest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small living room: 16x12, 2 spp, detail 1 (1,024 triangles)
W, H, SPP, SEED, LANES = 16, 12, 2, 5, 4096
#: target rows: one range inside the image, one that ends at its last row
TARGETS = ((3, 4), (9, 11))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _furnace(directory, integrators, references, name="furnace.xml"):
    """chip_smoke.py's furnace t-test at 4,000 rays per scene, written with
    its OBJ to `directory` as `name`; returns the XML's path."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.write_furnace(str(directory))
    path = directory / name
    path.write_text(chip_smoke.furnace_xml(integrators, references,
                                           samples=4000))
    return str(path)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """(rows, the tool's rows, the uncut JAX image, the tool's ranges)."""
    tool = _load(os.path.join(REPO, "tools", "reference_rows.py"),
                 "reference_rows_tool")
    merged = jax_config.MERGED_SWEEP
    try:
        jax_config.MERGED_SWEEP = False
        # uncut: one chunk of every work item
        uncut, _ = jax_wf.render_wavefront(
            jax_scenes.living_room(W, H, SPP, detail=1), spp=SPP, seed=SEED,
            n_lanes=LANES, chunk=W * H * SPP)
        rows, img, ranges = tool.reference_rows(
            jax_scenes.living_room(W, H, SPP, detail=1), SPP, SEED, TARGETS,
            LANES, str(tmp_path_factory.mktemp("jax_rows")), log=lambda *a,
            **k: None)
    finally:
        jax_config.MERGED_SWEEP = merged
    return rows, img, uncut, ranges


def test_row_resume_matches_an_uncut_jax_render(jax_rows):
    """The rows the tool renders, one row per chunk from a checkpoint at
    the first row its targets' taps reach (two rows each way), are those
    of the JAX package's render of every work item in one chunk: the
    chunking moves only the order of the film's sums."""
    rows, img, uncut, ranges = jax_rows
    assert rows.tolist() == [3, 4, 9, 10, 11]
    assert [r["rendered_rows"] for r in ranges] == [[1, 6], [7, 11]]
    assert [r["q"] for r in ranges] == [[W * SPP, 7 * W * SPP],
                                        [7 * W * SPP, H * W * SPP]]
    assert img.dtype == np.float32 and img.shape == (5, W, 3)
    assert (img > 0).any()
    np.testing.assert_allclose(img, uncut[rows], rtol=1e-5, atol=1e-6)


def test_port_row_resume_passes_the_exact_gate(jax_rows, tmp_path,
                                              monkeypatch):
    """rmse_gate.render_rows (the port, CPU) over the tool's row ranges
    passes the exact gate against the JAX rows, with the JAX rays.  The
    port sweeps the Moller-Trumbore soup, the test of the JAX package's
    CPU scan: at 80 pixels 1% is less than one, and the Baldwin-Weber
    operand's last-bit differences re-seed a path or two."""
    monkeypatch.setattr(config, "USE_BW_SWEEP", False)
    rows, img, _, ranges = jax_rows
    sc = torch_scenes.living_room(W, H, SPP, detail=1)
    got = np.zeros_like(img)
    for r in ranges:
        first, last = r["rendered_rows"]
        full, st = rmse_gate.render_rows(sc, SEED, first, last, LANES,
                                         str(tmp_path), "cpu")
        keep = (rows >= first) & (rows <= last)
        got[keep] = full[rows[keep]]
        assert st["rays"] == r["rays"]
        assert st["done"] == (last == H - 1)
    gate = rmse_gate.exact_gate(got, img)
    assert gate["pass"], gate


def test_composite_reference(tmp_path, monkeypatch):
    """With the npz, the full-size link holds the render to the npz on
    its rows and to the EXR elsewhere; without it, wrong EXR rows fail
    the whole image while the rows outside them pass."""
    fw, fh = 24, 16
    rows = np.array([3, 4, 13, 14, 15])
    rng = np.random.RandomState(4)
    img = rng.rand(fh, fw, 3).astype(np.float32)
    exr = img.astype(np.float16).astype(np.float32)
    exr[rows] += 2.0  # the EXR's rows are wrong
    row_img = img[rows] + np.float32(1e-4)  # the npz's are right
    comp = rmse_gate.composite_reference(exr, rows, row_img)
    np.testing.assert_array_equal(comp[rows], row_img)
    others = np.setdiff1d(np.arange(fh), rows)
    np.testing.assert_array_equal(comp[others], exr[others])

    full_ref = str(tmp_path / "full.exr")
    write_exr(full_ref, exr)
    npz = str(tmp_path / "rows.npz")
    np.savez(npz, img=row_img, rows=rows, seed=11, spp=1024,
             resolution=np.array([fw, fh]))

    def render(width, height, spp, seed, n_lanes, device=None):
        out = img if (width, height) == (fw, fh) else np.random.RandomState(
            seed).rand(height, width, 3).astype(np.float32)
        return out, {"mrays_per_sec": 1.0, "rays": 1, "seconds": 1.0}

    ragged = np.zeros(fh, bool)
    ragged[rows] = True
    monkeypatch.setattr(rmse_gate, "_render", render)
    monkeypatch.setattr(rmse_gate, "FULL_W", fw)
    monkeypatch.setattr(rmse_gate, "FULL_H", fh)
    monkeypatch.setattr(rmse_gate, "reference_ragged_rows",
                        lambda *a: ragged)
    small = tmp_path / "small.npz"
    s = rmse_gate.SMALL
    np.savez(small, config=json.dumps(s),
             img=render(s["width"], s["height"], 4, s["seed"], 0)[0])
    kw = dict(spp_full=1024, device="cpu", json_out=None,
              ref_npz=str(small), full_ref=full_ref)
    with_rows = rmse_gate.run_gate(full_rows=npz, **kw)["exact_gate_full"]
    assert with_rows["pass"] and with_rows["jax_rows"] == rows.tolist()
    assert with_rows["outside_ragged_rows"]["pass"]
    on = with_rows["ragged_rows_against_jax_rows"]
    assert on["pass"] and on["max_abs_diff"] == pytest.approx(1e-4, rel=1e-2)
    without = rmse_gate.run_gate(full_rows=str(tmp_path / "none.npz"), **kw)
    full = without["exact_gate_full"]
    assert not full["pass"] and full["outside_ragged_rows"]["pass"]
    assert "ragged_rows_against_jax_rows" not in full


def test_run_fixture_matches_the_jax_runner(tmp_path, monkeypatch):
    """A furnace t-test of 4,000 rays (path_mis), both packages on the
    scan backend: equal ok, passed and total."""
    monkeypatch.setattr(jax_config, "accel_mode", "scan")
    monkeypatch.setattr(config, "accel_mode", "scan")
    xml = _furnace(tmp_path, ["path_mis"], [2.0])
    jax_runner = _load(os.path.join(REPO, "scripts", "ref_gates.py"),
                       "jax_ref_gates")
    want = jax_runner.run_fixture(xml)
    got = ref_gates.run_fixture(xml, device="cpu")
    assert want["ok"] and want["total"] == 1
    for key in ("ok", "passed", "total"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("name, count", [("smoke-furnace.xml", 4000),
                                         ("smoke-scene.xml", 1000)])
def test_scale_spares_the_furnace(tmp_path, monkeypatch, name, count):
    """--scale divides a fixture's sample count (floor 1,000) unless its
    file name holds "furnace", in both runners."""
    path = _furnace(tmp_path, ["path_mis"], [2.0], name)
    jax_runner = _load(os.path.join(REPO, "scripts", "ref_gates.py"),
                       "jax_ref_gates")
    seen = []

    def run(self, verbose=True, device=None):
        seen.append(self.sample_count)
        print("Passed 1/1 t-tests.")
        return True

    monkeypatch.setattr(ttest.StudentsTTest, "run", run)
    monkeypatch.setattr(jax_ttest.StudentsTTest, "run", run)
    got = ref_gates.run_fixture(path, scale=16, device="cpu")
    want = jax_runner.run_fixture(path, scale=16)
    assert seen == [count, count]
    assert (got["ok"], got["passed"], got["total"]) == (True, 1, 1)
    assert (want["ok"], want["passed"], want["total"]) == (True, 1, 1)


def test_missing_fixtures_fail_the_gate(tmp_path, monkeypatch, capsys):
    """A root holding one fixture: it runs and passes, the other five are
    recorded as missing, all_ok is false and main exits 1; the record
    names the device."""
    root = tmp_path / "scenes"
    tests_dir = root / "pa4" / "tests"
    tests_dir.mkdir(parents=True)
    _furnace(tests_dir, ["path_mats"], [2.0], "test-mesh-furnace.xml")
    out = tmp_path / "gates.json"
    assert ref_gates.main([str(out), "--root", str(root),
                           "--device", "cpu"]) == 1
    rec = json.loads(out.read_text())
    assert rec["device"]["name"] == "cpu" and rec["scale"] == 1
    assert rec["all_ok"] is False and rec["root"] == str(root)
    fx = rec["fixtures"]
    assert list(fx) == [os.path.basename(f) for f in ref_gates.FIXTURES]
    ran = fx.pop("test-mesh-furnace.xml")
    assert (ran["ok"], ran["passed"], ran["total"]) == (True, 1, 1)
    assert all(r == {"error": "fixture missing from checkout"}
               for r in fx.values())
    assert "GATE FAILURES" in capsys.readouterr().out


def test_runner_without_a_card_exits_2(monkeypatch, tmp_path, capsys):
    """The default device is the card: without one, exit 2 and no
    record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "gates.json"
    assert ref_gates.main([str(out), "--root", str(tmp_path)]) == 2
    assert not out.exists()
    assert "no CUDA device" in capsys.readouterr().err


def test_default_root_is_the_jax_runners():
    """Without --root the runner looks where scripts/ref_gates.py looks."""
    jax_runner = _load(os.path.join(REPO, "scripts", "ref_gates.py"),
                       "jax_ref_gates")
    root = ref_gates.jax_runner_root()
    assert sorted(os.path.join(root, f) for f in ref_gates.FIXTURES) == \
        sorted(jax_runner.FIXTURES)
