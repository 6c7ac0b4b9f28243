"""The traced section's reduction and the metric readers, on synthetic
events: busy time is the union of device intervals, idle gaps go to
the innermost host event open at their middle, and each reader turns
the run's context into its number or into nothing."""

import pytest

from benchmark import devtrace
from benchmark import manifest as mf


def test_summarize_union_and_gap_credit():
    dev = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3")]
    host = [(0, 200, "outer"), (22, 28, "aten::mul"), (50, 90, "sync")]
    s = devtrace.summarize(dev, host, 1e-6)
    assert s["busy_s"] == pytest.approx(40e-9)
    assert s["device_ops"] == 4
    assert s["kernel_s"]["k1"] == pytest.approx(20e-9)
    # gap 20-30 (middle 25) inside aten::mul; gap 40-100 (middle 70)
    # inside sync
    assert s["idle_gaps"] == pytest.approx({"aten::mul": 10e-9,
                                            "sync": 60e-9})
    assert devtrace.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]


def _ctx(trace=None, steps=264, batches=None):
    im = {"seconds": 6.0, "rays": 100_000_000,
          "steps": steps, "batches": batches}
    return {"samples_per_image": 1000, "setup_s": 12.0, "compile_s": 0.5,
            "window_s": 12.2, "images": [im, dict(im)],
            "peak_bytes": 2 ** 31, "trace": trace}


def test_readers():
    r = {m: mf.reader(m) for m in (
        "samples_per_s", "setup_s", "scene_compile_s", "ms_per_step",
        "ms_per_batch", "device_ops_per_step", "device_ops_per_batch",
        "mrays_per_s", "rays_per_sample", "sweep_ms_per_mray",
        "device_idle_pct", "peak_mem_gib")}
    ctx = _ctx()
    assert r["samples_per_s"](ctx) == pytest.approx(2000 / 12.2)
    assert r["ms_per_step"](ctx) == pytest.approx(1e3 * 12 / 528)
    assert r["ms_per_batch"](ctx) is None
    assert r["mrays_per_s"](ctx) == pytest.approx(200 / 12)
    assert r["rays_per_sample"](ctx) == pytest.approx(1e5)
    assert r["peak_mem_gib"](ctx) == 2.0
    for name in ("device_ops_per_step", "sweep_ms_per_mray",
                 "device_idle_pct"):
        assert r[name](ctx) is None          # untraced: nothing to read
    trace = {"busy_s": 1.0, "window_s": 4.0, "device_ops": 3000,
             "kernel_s": {
                 "void resident_first_pass<1, true, false>(float const*)":
                     0.2,
                 "entry_min_kernel(float4 const*, int)": 0.1,
                 "void at::native::elementwise_kernel<4>(int)": 5.0},
             "images": [{"seconds": 1.0, "rays": 10_000_000, "steps": 2,
                         "batches": None}]}
    ctx = _ctx(trace)
    assert r["device_ops_per_step"](ctx) == 1500
    assert r["sweep_ms_per_mray"](ctx) == pytest.approx(300 / 10)
    assert r["device_idle_pct"](ctx) == pytest.approx(100 * (1 - 1.0 / 6.1))
    # a CPU run's section has no device operations: no device number
    cpu = _ctx({**trace, "busy_s": 0.0, "device_ops": 0, "kernel_s": {}})
    for name in ("device_ops_per_step", "sweep_ms_per_mray",
                 "device_idle_pct"):
        assert r[name](cpu) is None
