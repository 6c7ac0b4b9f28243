"""The program's spans in the benchmark: idle gaps credited to the
innermost span open at their middle, self time, the five span readers
on a synthetic context, a span run of each cell at a tiny size on the
CPU, and on the card that the spans and the device trace share one
clock (python -m pytest benchmark/tests -m card)."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import manifest as mf
from benchmark import spantrace
from benchmark.spanrun import run_spans
from benchmark.tests.test_benchmark_run import SEED, TINY

READERS = ("step_enqueue_ms", "sync_wait_ms_per_batch",
           "host_syncs_per_batch", "prepare_ms_per_image",
           "idle_unspanned_pct")


def _rec(i, parent, name, start, end, image=0):
    return [i, parent, image, name, start, end]


def test_credit_innermost_and_unspanned():
    recs = [_rec(0, -1, "image", 100, 1000),
            _rec(1, 0, "step", 200, 500),
            _rec(2, 1, "sync.pending", 300, 400),
            _rec(3, 0, "splat", 600, 700)]
    gaps = [(310, 390),      # middle 350: sync.pending, inside step
            (210, 250),      # middle 230: step
            (500, 560),      # middle 530: image, between its children
            (20, 60),        # middle 40: before every span
            (1100, 1200)]    # middle 1150: after every span
    by, unspanned = spantrace.credit_spans(gaps, recs)
    assert by == pytest.approx({"sync.pending": 80e-9, "step": 40e-9,
                                "image": 60e-9})
    assert unspanned == pytest.approx(140e-9)
    assert spantrace.credit_spans([], recs) == ({}, 0.0)


def test_gaps_of_the_device_union():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (35, 38, "c"),
           (100, 110, "d")]
    assert spantrace.gaps_of(dev) == [(20, 30), (40, 100)]


def test_self_seconds():
    recs = [_rec(0, -1, "image", 0, 1000),
            _rec(1, 0, "step", 100, 500),
            _rec(2, 1, "step.sort", 150, 450),
            _rec(3, 0, "step", 600, 700)]
    assert spantrace.self_seconds(recs) == pytest.approx(
        {"image": 500e-9, "step": 200e-9, "step.sort": 300e-9})


def _ctx(spans=None, trace=None):
    return {"samples_per_image": 1000, "setup_s": 12.0, "compile_s": 0.5,
            "window_s": 12.2, "images": [], "peak_bytes": 0,
            "trace": trace, "spans": spans}


def test_span_readers():
    r = {m: mf.reader(m) for m in READERS}
    for name in READERS:
        assert r[name](_ctx()) is None          # nothing to read
    ms = 1_000_000
    wavefront = {"records": [
        _rec(0, -1, "image", 0, 100 * ms),
        _rec(1, 0, "prepare", 0, 5 * ms),
        _rec(2, 0, "build", 5 * ms, 6 * ms),
        _rec(3, 0, "step", 10 * ms, 30 * ms),
        _rec(4, 3, "step.sort", 12 * ms, 20 * ms),
        _rec(5, 0, "step", 30 * ms, 40 * ms),
        _rec(6, 0, "sync.pending", 40 * ms, 41 * ms)],
        "counters": {"steps": 2, "host_syncs": 1,
                     "host_syncs.pending": 1}}
    ctx = _ctx(wavefront)
    assert r["step_enqueue_ms"](ctx) == pytest.approx(15.0)
    assert r["prepare_ms_per_image"](ctx) == pytest.approx(6.0)
    assert r["sync_wait_ms_per_batch"](ctx) is None      # no batches
    assert r["host_syncs_per_batch"](ctx) is None
    batch = {"records": [
        _rec(0, -1, "image", 0, 100 * ms),
        _rec(1, 0, "prepare", 0, 30 * ms),
        _rec(2, 0, "batch", 30 * ms, 60 * ms),
        _rec(3, 2, "batch.depth", 30 * ms, 40 * ms),
        _rec(4, 3, "sync.alive", 30 * ms, 32 * ms),
        _rec(5, 0, "batch", 60 * ms, 90 * ms),
        _rec(6, 5, "batch.depth", 60 * ms, 70 * ms),
        _rec(7, 6, "sync.alive", 60 * ms, 61 * ms),
        _rec(8, 0, "sync.copy_out", 90 * ms, 95 * ms)],
        "counters": {"batches": 2, "host_syncs": 3}}
    ctx = _ctx(batch)
    assert r["step_enqueue_ms"](ctx) is None             # no steps
    assert r["sync_wait_ms_per_batch"](ctx) == pytest.approx(4.0)
    assert r["host_syncs_per_batch"](ctx) == pytest.approx(1.5)
    assert r["prepare_ms_per_image"](ctx) == pytest.approx(30.0)
    trace = {"busy_s": 1.0, "idle_s": 2.0, "idle_unspanned_s": 0.1}
    assert r["idle_unspanned_pct"](_ctx(trace=trace)) == pytest.approx(5.0)
    assert r["idle_unspanned_pct"](_ctx(trace={"busy_s": 1.0})) is None


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_span_run_on_the_cpu(_threads, workload):
    """A span run at a tiny size: the counters agree with the drivers'
    stats, the image is the same with spans on, and every span metric of
    the cell's driver reads something (idle needs a device trace)."""
    res = run_spans(workload, SEED, 0.0, device="cpu",
                    overrides=TINY[workload])
    agree = res["counters"]["agree"]
    assert agree["steps"][0] == agree["steps"][1]
    assert agree["batches"][0] == agree["batches"][1]
    assert res["cost"]["bit_equal"] is True
    wavefront = "path_mis" in workload
    assert ("step_enqueue_ms" in res["metrics"]) == wavefront
    assert ("host_syncs_per_batch" in res["metrics"]) != wavefront
    assert ("sync_wait_ms_per_batch" in res["metrics"]) != wavefront
    assert res["metrics"]["prepare_ms_per_image"] > 0
    assert "idle_unspanned_pct" not in res["metrics"]
    assert res["breakdown"]["span_self_s"]
    assert min(v for _, v in res["breakdown"]["span_self_s"]) >= 0.0
    if workload == "ajax.normals":
        # one image's ray count and copy to the host over its batches
        batches = agree["batches"][0]
        assert res["metrics"]["host_syncs_per_batch"] == pytest.approx(
            2 * res["sections"]["span_images"] / batches)


def _clock_probe() -> dict:
    """On the card, with spans on: a kernel, 20 ms of host sleep, then
    inside span("probe") a kernel that spins for about a millisecond,
    50 ms of host sleep, a second kernel and a synchronise; traced once
    under torch.profiler (device activity) and once through
    spantrace.profiled.  Then a kernel launched inside span("launch")
    that runs on after it, and one inside span("later")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nori_tpu_torch import spans

    card = torch.device("cuda")
    x = torch.zeros(1024, device=card)

    def section():
        x.add_(1.0)
        time.sleep(0.02)
        with spans.span("probe"):
            torch.cuda._sleep(2_000_000)
            time.sleep(0.05)
            x.add_(1.0)
            torch.cuda.synchronize(card)

    def launches():
        with spans.span("launch"):
            torch.cuda._sleep(2_000_000)
        with spans.span("later"):
            x.add_(1.0)
        time.sleep(0.01)

    section()                                   # warm
    spans.take()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            section()
    finally:
        spans.disable()
    recs = [list(r) for r in spans.take()["records"]]
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    _, tsum = spantrace.profiled(section, card)
    _, launched = spantrace.profiled(launches, card)
    return {"recs": recs, "dev": dev,
            "tsum": {k: tsum[k] for k in ("device_ops", "idle_by_span",
                                          "idle_unspanned_s", "idle_s")},
            "device_by_span": launched["device_by_span"]}


@pytest.fixture(scope="module")
def clock_probe():
    """_clock_probe's readings from a process of their own: in one
    that had already traced the cells (test_benchmark_card), a further
    device-only trace recorded no device operation at all."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the probe traces the card")
    code = ("import json; from benchmark.tests.test_benchmark_spans "
            "import _clock_probe; print(json.dumps(_clock_probe()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
def test_spans_share_the_device_trace_clock(card, clock_probe):
    """Both kernels inside span("probe") have device intervals within
    the span, and the idle gap between them goes to `probe`; the gap
    before the span, while the host slept outside any span, goes to
    none."""
    recs, dev = clock_probe["recs"], clock_probe["dev"]
    assert len(dev) == 3 and [r[3] for r in recs] == ["probe"]
    start, end = recs[0][4], recs[0][5]
    assert dev[0][1] < start
    for s, e, _ in dev[1:]:
        assert start <= s <= e <= end
    by, unspanned = spantrace.credit_spans(spantrace.gaps_of(dev), recs)
    # the 50 ms sleep less the spinning kernel's ~1 ms; 20 ms before
    assert set(by) == {"probe"} and 0.03 < by["probe"] < 0.06
    assert 0.01 < unspanned < 0.03

    # the same through the section the span metrics read
    tsum = clock_probe["tsum"]
    assert tsum["device_ops"] == 3
    assert set(tsum["idle_by_span"]) == {"probe"}
    assert 0.03 < tsum["idle_by_span"]["probe"] < 0.06
    assert 0.01 < tsum["idle_unspanned_s"] < 0.03
    assert tsum["idle_s"] == pytest.approx(
        tsum["idle_by_span"]["probe"] + tsum["idle_unspanned_s"])


@pytest.mark.card
def test_device_time_goes_to_the_launching_span(card, clock_probe):
    """A kernel's device seconds go to the span open when the host
    launched it, though the kernel runs after the span has closed."""
    dev = clock_probe["device_by_span"]
    assert set(dev) == {"launch", "later"}
    assert dev["launch"] > 0.0005 > dev["later"]
