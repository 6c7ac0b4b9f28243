"""A run's result line, its refusals, and `correct` under planted faults.

The fault tests skip the harness's look for a card and drive the rest of
a run on the CPU at a tiny size, with the timed path broken underneath:
a step that leaves its state unchanged (the film splat adds nothing),
half of each batch left out with the mean taken over the rest, and the
answers altered where they are produced (every sample's radiance off by
a tenth of a percent).  Each must come out `correct: false`; the same
run unbroken comes out true.  (No cell runs on more than one card, so
the exchange between cards has no fault to plant.)
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import manifest as mf
from benchmark.run import run_cell

ROOT = mf.ROOT
SEED = 2 ** 32 + 99
#: tiny sizes of each cell for the CPU
TINY = {
    "cbox.path_mis": {"config": {"width": 32, "height": 24},
                      "cell": {"spp": 4, "n_lanes": 4096}},
    "living_room.path_mis": {"config": {"width": 32, "height": 20,
                                        "detail": 1},
                             "cell": {"spp": 2, "n_lanes": 4096}},
    "ajax.whitted": {"config": {"width": 24, "height": 24, "n_lat": 24,
                                "n_lon": 20},
                     "cell": {"spp": 2, "batch": 4096}},
    "ajax.normals": {"config": {"width": 24, "height": 24, "n_lat": 24,
                                "n_lon": 20},
                     "cell": {"spp": 2, "batch": 4096}},
}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(workload, trace=False):
    return run_cell(workload, SEED, 0.0, trace, device="cpu",
                    overrides=TINY[workload])


def test_result_line_keys():
    res = _run("cbox.path_mis", trace=True)
    assert set(res) == KEYS | {"breakdown"}
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["check"]) == {"err_p50", "err_p90", "img_p50_max"}
    assert {"value", "limit"} == set(res["check"]["err_p50"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run writes no number under a device metric
    for name in ("device_idle_pct", "sweep_ms_per_mray",
                 "device_ops_per_step", "peak_mem_gib"):
        assert name not in res["metrics"]
    res = _run("ajax.normals")
    assert set(res) == KEYS and list(res)[-1] == "check"
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}


def _break(monkeypatch, fault):
    """Plant `fault` in the port's timed path."""
    import nori_tpu_torch.render as render
    import nori_tpu_torch.wavefront as wavefront

    if fault == "state_unchanged":
        make = wavefront.make_dense_splat

        def make_dense_splat(*a, **k):
            new_film, _, finalize = make(*a, **k)
            return new_film, lambda film, *args: film, finalize

        monkeypatch.setattr(wavefront, "make_dense_splat", make_dense_splat)
        return

    def alter(vals):
        vals = vals.clone()
        if fault == "half_left_out":
            vals[1::2] = vals[0::2][:vals[1::2].shape[0]]
        else:
            vals = vals * 1.001
        return vals

    run_chunk = wavefront.run_chunk

    def broken_chunk(*a, **k):
        L, rays, counts = run_chunk(*a, **k)
        return alter(L), rays, counts

    monkeypatch.setattr(wavefront, "run_chunk", broken_chunk)
    make_q = render.make_sample_pass_q

    def make_sample_pass_q(*a, **k):
        fn = make_q(*a, **k)

        def pass_fn(sd, seed, q0):
            vals, rays = fn(sd, seed, q0)
            return alter(vals), rays

        return pass_fn

    monkeypatch.setattr(render, "make_sample_pass_q", make_sample_pass_q)


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    _break(monkeypatch, fault)
    res = _run(workload)
    assert res["correct"] is False, res["check"]


def test_one_wrong_image_among_many_is_not_correct(monkeypatch):
    """One image of a dozen or more, its answers off by a tenth of a
    percent, fails the run by its own median although the run's pooled
    numbers stay inside their limits."""
    from benchmark import port

    render_image = port.render_image
    calls = []

    def one_wrong(scene, traffic, seed, device):
        img, st = render_image(scene, traffic, seed, device)
        calls.append(seed)
        return (img * 1.001 if len(calls) == 4 else img), st

    class Clock:
        """Each reading a quarter of a second on: a window of 3.5 s
        holds 14 images however fast they render."""
        now = 0.0

        @classmethod
        def perf_counter(cls):
            cls.now += 0.25
            return cls.now

    import benchmark.run

    monkeypatch.setattr(port, "render_image", one_wrong)
    monkeypatch.setattr(benchmark.run, "time", Clock)
    res = run_cell("ajax.normals", SEED, 3.5, False, device="cpu",
                   overrides=TINY["ajax.normals"])
    assert res["attempted"] >= 11
    assert res["correct"] is False and res["failed"] == 1
    chk = res["check"]
    for k in ("err_p50", "err_p90"):
        assert chk[k]["value"] <= chk[k]["limit"]
    assert chk["img_p50_max"]["value"] > chk["img_p50_max"]["limit"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_in_the_programs_place_is_not_correct(monkeypatch, workload):
    """The control (the reference with its path state in bfloat16) put
    where the program's images come from fails the comparison."""
    from benchmark import port
    from benchmark.reference.render import Reference

    man = mf.load()
    config = mf.workload(man, workload)["config"]
    desc = mf.scene_builder(config)(
        {**mf.config(man, config), **TINY[workload]["config"]})

    def control_image(scene, traffic, seed, device):
        ref = Reference(desc, traffic, device, lowp=True)
        w, h = scene.camera.output_size
        img = ref.blocks([(seed, 0, 0)], max(w, h))[0][:h, :w]
        return img.astype("float32"), {"seconds": 1.0, "rays": 1}

    monkeypatch.setattr(port, "render_image", control_image)
    assert _run(workload)["correct"] is False


def _sub(code, cwd, env=None, timeout=600):
    return subprocess.run([sys.executable, *code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_without_a_card_it_exits_and_prints_no_result():
    out = _sub(["-m", "benchmark.run", "--workload", "cbox.path_mis",
                "--seed", str(SEED), "--seconds", "1", "--trace", "0"], ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "unavailable" in out.stderr


def test_benchmark_alone_is_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    fails and prints no result: the program is not there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = textwrap.dedent(f"""
        from benchmark.run import run_cell
        print(run_cell("cbox.path_mis", 1, 0.0, False, device="cpu",
                       overrides={TINY["cbox.path_mis"]!r}))
    """)
    out = _sub(["-c", code], tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "nori_tpu_torch" in out.stderr
    out = _sub(["-m", "benchmark.run", "--workload", "cbox.path_mis",
                "--seed", "1", "--seconds", "1", "--trace", "0"],
               tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_jax_in_a_run():
    """A CPU run of a cell loads no module whose top-level name is jax,
    jaxlib, flax or nori_tpu (nori_tpu_torch is another name), and the
    reference alone loads nothing of the program."""
    code = textwrap.dedent(f"""
        import sys, json, torch
        torch.set_num_threads(2)
        from benchmark.run import run_cell, forbidden_modules
        run_cell("cbox.path_mis", 7, 0.0, True, device="cpu",
                 overrides={TINY["cbox.path_mis"]!r})
        print(json.dumps([forbidden_modules(),
                          "nori_tpu_torch" in sys.modules]))
    """)
    out = _sub(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]
    code = textwrap.dedent("""
        import sys, json
        from benchmark import manifest as mf
        from benchmark.reference.render import Reference
        man = mf.load()
        cfg = {**mf.config(man, "cbox"), "width": 16, "height": 12}
        desc = mf.scene_builder("cbox")(cfg)
        Reference(desc, {"integrator": "path_mis", "spp": 1}, "cpu").blocks(
            [(3, 0, 0)], 8)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                                & {"jax", "jaxlib", "flax", "nori_tpu",
                                   "nori_tpu_torch"})))
    """)
    out = _sub(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
