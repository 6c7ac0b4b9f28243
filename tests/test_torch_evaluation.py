"""The port's measurement and evaluation entry points on the CPU:
`nori_tpu_torch.bench` (a row's fields, rays and image hashes; the
no-device record; the budget's skips), and the port's rmse_gate,
pathgraph_eval and pg_protocol_report against the repository's JAX-side
scripts on the same seeded inputs (the scripts loaded by path, their
renders and dumps replaced by seeded images or resumed from seeded
checkpoints, so nothing here renders at a cost)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nori_tpu_torch import bench
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch.bitmap import write_exr
from nori_tpu_torch.scripts import pathgraph_eval as torch_eval
from nori_tpu_torch.scripts import pg_protocol_report as torch_report
from nori_tpu_torch.scripts import rmse_gate as torch_gate
from nori_tpu_torch.wavefront import render_wavefront

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: bench.py's row fields (bench.py:110-127), less `tune`: the port has
#: no per-scene tuning
BENCH_FIELDS = ("driver", "mrays_per_sec", "samples_per_sec", "seconds",
                "rays", "spp", "triangles", "mean_radiance", "occupancy",
                "steps", "row_seconds")


def _script(name: str, where: str = os.path.join(REPO, "scripts")):
    """<where>/<name>.py of the repository (by default under scripts/),
    loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_side_{name}", os.path.join(where, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

def test_bench_row_on_the_cpu():
    """A row on a 32x24 Cornell box at 2 spp and 1,024 lanes: bench.py's
    fields, equal to bench.py's row (`_bench_scene`, loaded by path) on
    the JAX package's same scene, whose rays are its render_wavefront's
    for the same seed; two equal image hashes; and launch counts of
    every kernel (0 on the CPU, where the wrappers run their plain
    versions)."""
    from nori_tpu import scenes_builtin as jax_scenes

    jax_row = _script("bench", REPO)._bench_scene(
        jax_scenes.cornell_box(32, 24, 2, sphere_subdiv=1), 2, n_lanes=1024)
    row = bench.bench_scene(
        torch_scenes.cornell_box(32, 24, 2, sphere_subdiv=1), 2, 1024,
        "cpu")
    assert set(BENCH_FIELDS) <= set(row)
    assert row["driver"] == "wavefront" and row["spp"] == 2
    assert row["rays"] > 0 and row["rays_each"] == [row["rays"]] * 2
    assert len(row["sha1"]) == 2 and row["sha1"][0] == row["sha1"][1]
    assert row["seconds"] == float(np.median(row["seconds_each"]))
    assert set(row["launches"]) == {
        "entry_min", "resident_sweep", "resident_sweep_mxu", "lane_keys",
        "resident_sweep_mixed", "stream_sweep", "stream_sweep_culled",
        "mt_sweep"}
    assert not any(row["launches"].values())
    assert row["triangles"] > 0 and 0.0 < row["mean_radiance"]
    for k in ("driver", "rays", "spp", "triangles", "steps"):
        assert row[k] == jax_row[k], k
    # bench.py rounds the mean to 4 places and the occupancy to 3
    assert abs(row["mean_radiance"] - jax_row["mean_radiance"]) <= 1e-4
    assert abs(row["occupancy"] - jax_row["occupancy"]) <= 1e-3


def test_bench_without_a_card_exits_2():
    """`python bench_torch.py` with no CUDA device: an "unavailable"
    record as its last line, exit code 2."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "mrays_per_sec_living_room"
    assert rec["value"] == 0.0 and "unavailable" in rec["error"]


def test_bench_budget_skips_later_rows(monkeypatch, capsys):
    """With a budget spent by the headline row, every later row lands in
    `skipped` (those without a reference XML as missing), and every line
    printed, the last too, is a complete record."""
    monkeypatch.setattr(bench, "ROOM",
                        dict(width=16, height=16, spp=1, detail=1))
    monkeypatch.setattr(bench, "ROOM_LANES", 4096)
    monkeypatch.setenv("BENCH_TIME_BUDGET", "1")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(line) for line in lines]
    assert records[0].get("partial") is True
    last = records[-1]
    assert "partial" not in last
    assert set(last["breakdown"]) == {"living_room"}
    assert last["value"] == last["breakdown"]["living_room"]["mrays_per_sec"]
    assert last["device"]["name"] == "cpu"
    over = {s["row"] for s in last["skipped"] if "est_s" in s}
    missing = {s["row"] for s in last["skipped"] if "missing" in s}
    assert over == {"cbox_mis", "ajax_normals", "ajax_rough",
                    "kernel_living_room"}
    assert missing == {"table_mis", "veach_mis"}


# ---------------------------------------------------------------------------
# the matched-RMSE gate
# ---------------------------------------------------------------------------

def _fake_render(width, height, spp, seed, n_lanes, device=None):
    """A seeded stand-in for a render: one fixed image plus noise of
    0.3 / sqrt(spp) drawn from `seed`."""
    base = np.random.RandomState(5).rand(height, width, 3)
    noise = np.random.RandomState(seed).randn(height, width, 3)
    img = (base + 0.3 / np.sqrt(spp) * noise).astype(np.float32)
    return img, {"mrays_per_sec": 17.5, "rays": 123456 + seed,
                 "seconds": 1.25}


@pytest.mark.parametrize("offset", [2e-4, 3e-3])
def test_rmse_gate_matches_the_jax_script(tmp_path, monkeypatch, offset):
    """rmse and every verdict of the port's gate equal those of
    scripts/rmse_gate.py on the same seeded images: the small reference
    offset by `offset` on a tenth of its pixels (passes at 2e-4, fails at
    3e-3); and link 1 at full size passes against the seed-11 image
    stored as a half EXR."""
    jax_gate = _script("rmse_gate")
    small = torch_gate.SMALL
    assert jax_gate.SMALL == small
    assert jax_gate.rmse(np.ones(3), np.zeros(3)) == torch_gate.rmse(
        np.ones(3), np.zeros(3))
    ref, _ = _fake_render(small["width"], small["height"], small["spp"],
                          small["seed"], small["n_lanes"])
    mask = np.random.RandomState(9).rand(*ref.shape[:2]) < 0.1
    ref = ref + np.where(mask[..., None], offset, 0.0).astype(np.float32)
    npz = tmp_path / "ref.npz"
    np.savez_compressed(npz, img=ref, config=json.dumps(small))
    full_w, full_h = 24, 16
    full_ref = str(tmp_path / "full.exr")
    write_exr(full_ref, _fake_render(full_w, full_h, 1024, 11, 0)[0])
    for mod in (jax_gate, torch_gate):
        monkeypatch.setattr(mod, "_render", _fake_render)
        monkeypatch.setattr(mod, "FULL_W", full_w)
        monkeypatch.setattr(mod, "FULL_H", full_h)
    monkeypatch.setattr(jax_gate, "REF_NPZ", str(npz))
    monkeypatch.setattr(jax_gate, "OUT_JSON", str(tmp_path / "jax.json"))
    want = jax_gate.run_gate(spp_full=1024)
    got = torch_gate.run_gate(spp_full=1024, device="cpu",
                              json_out=str(tmp_path / "torch.json"),
                              ref_npz=str(npz), full_ref=full_ref,
                              full_rows=str(tmp_path / "no_rows.npz"))
    assert want["exact_gate"]["pass"] == (offset < 1e-3)
    for link in ("exact_gate", "mc_scaling", "matched_gate"):
        for key, value in want[link].items():
            if key not in ("seconds", "spp_per_sec"):
                assert got[link][key] == value, (link, key)
    full = got["exact_gate_full"]
    assert full["stored_as"] == ["half"] and full["pass"]
    assert full["rmse"] == 0.0 and full["outside_ragged_rows"]["pass"]
    assert json.loads((tmp_path / "torch.json").read_text()) == json.loads(
        json.dumps(got))


def test_reference_ragged_rows_are_those_the_jax_splat_moves():
    """The rows reference_ragged_rows names are exactly those where the
    JAX package's render in chunks that leave a ragged last chunk (384
    of 512 work items) differs from the port's, whose ragged render
    equals its uncut one: the JAX splat's clamped slices misplace the
    last chunk's samples, which is why the full-size gate against
    scratch/living_room_1024spp.exr (29 chunks, the last ragged) fails
    on the whole image (ROADMAP Queue 3)."""
    from nori_tpu import scenes_builtin as jax_scenes
    from nori_tpu import wavefront as jax_wf

    w, h, spp, chunk = 16, 16, 2, 384
    kw = dict(n_lanes=1024, seed=3)
    ref, _ = jax_wf.render_wavefront(
        jax_scenes.cornell_box(w, h, spp, sphere_subdiv=1), chunk=chunk, **kw)
    ragged, _ = render_wavefront(
        torch_scenes.cornell_box(w, h, spp, sphere_subdiv=1),
        chunk=chunk, device="cpu", **kw)
    uncut, _ = render_wavefront(
        torch_scenes.cornell_box(w, h, spp, sphere_subdiv=1),
        chunk=w * h * spp, device="cpu", **kw)
    np.testing.assert_allclose(ragged, uncut, rtol=1e-5, atol=1e-6)
    rows = torch_gate.reference_ragged_rows(w, h, spp, chunk, 2.0)
    moved = np.abs(ref - uncut).max(axis=(1, 2)) > 1e-4
    np.testing.assert_array_equal(moved, rows)
    np.testing.assert_allclose(ref[~rows], uncut[~rows], rtol=1e-5,
                               atol=1e-5)
    assert not torch_gate.reference_ragged_rows(w, h, spp, w * h * spp,
                                                2.0).any()
    # the full-size reference: 29 chunks of 32,768 pixels, the last of
    # 4,096
    full = torch_gate.reference_chunk(1280 * 720 * 1024, 524288, 1024)
    assert full == 1 << 25
    assert np.flatnonzero(torch_gate.reference_ragged_rows(
        1280, 720, 1024, full, 2.0)).tolist() == [697, 698, 699, 700] + list(
            range(714, 720))


# ---------------------------------------------------------------------------
# the path-graph evaluation protocol and its report
# ---------------------------------------------------------------------------

def _seeded_eval_dir(path, res: int, runs: int, seed: int = 3):
    """run_NNN.npz checkpoints and a complete pt_curve.json in `path`, a
    reference EXR beside it; returns the reference's path."""
    rng = np.random.RandomState(seed)
    os.makedirs(path)
    base = rng.rand(res, res, 3).astype(np.float32)
    for run in range(runs):
        np.savez(os.path.join(path, f"run_{run:03d}.npz"),
                 pg=(base + 0.1 * rng.randn(res, res, 3)).astype(np.float32),
                 pt=(base + 0.3 * rng.randn(res, res, 3)).astype(np.float32),
                 width=res, height=res, k=16, iters=3, seconds=1.5 + run)
    with open(os.path.join(path, "pt_curve.json"), "w") as f:
        json.dump({str(s): 0.4 / np.sqrt(s) for s in
                   (1, 2, 4, 8, 16, 32, 64, 128)}, f)
    ref = os.path.join(os.path.dirname(path), "ref.exr")
    write_exr(ref, base)
    return ref


def test_pathgraph_eval_resumes_like_the_jax_script(tmp_path, monkeypatch):
    """Both packages' evaluations resumed from the same seeded
    checkpoints, curve and --ref-exr give equal result JSONs key for key
    and byte-equal merged images, rendering nothing."""
    ref = _seeded_eval_dir(str(tmp_path / "jax"), 16, 2)
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    args = ["--scene", "cornell_box", "--res", "16", "--runs", "2",
            "--ref-exr", ref]
    monkeypatch.setattr(sys, "argv", ["pathgraph_eval.py"] + args + [
        "--out", str(tmp_path / "jax"), "--json-out",
        str(tmp_path / "jax.json")])
    _script("pathgraph_eval").main()
    torch_eval.main(args + ["--out", str(tmp_path / "torch"), "--json-out",
                            str(tmp_path / "torch.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    assert got == want
    assert want["runs"] == 2 and want["pg_seconds"] == 4.0
    for name in ("pg_k-16_merged.exr", "pt_same_samples.exr"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "torch" / name).read_bytes())


def test_pg_protocol_report_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's copy of scripts/pg_protocol_report.py gives its JSON on
    the same synthetic runs, box reference, curve and gaussian
    reference."""
    runs = tmp_path / "runs"
    ref = _seeded_eval_dir(str(runs), 12, 5)
    curve = tmp_path / "curve.json"
    curve.write_text(json.dumps(
        {"curve": [[2, 0.17854], [8, 0.12484], [32, 0.0707]]}))
    gauss = str(tmp_path / "gauss.exr")
    write_exr(gauss, np.random.RandomState(4).rand(12, 12, 3))
    args = ["--runs-dir", str(runs), "--box-ref", ref, "--box-curve",
            str(curve), "--gauss-ref", gauss]
    monkeypatch.setattr(sys, "argv", ["pg_protocol_report.py"] + args + [
        "--json-out", str(tmp_path / "jax.json")])
    _script("pg_protocol_report").main()
    got = torch_report.main(args + ["--json-out",
                                    str(tmp_path / "torch.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "torch.json").read_text()) == want
    assert want["runs"] == 5 and "pg_rmse_vs_gauss_ref" in want
    assert json.loads(json.dumps(got)) == want
