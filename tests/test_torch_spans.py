"""nori_tpu_torch.spans and the spans of the render drivers, on the CPU
at tiny sizes: off records nothing; on, the spans nest under one
`image` root and agree with the drivers' own counts; images are bit
for bit the same with spans on and off."""

import numpy as np
import pytest

from benchmark.spantrace import self_seconds
from nori_tpu_torch import render as torch_render
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import spans
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.integrators import whitted

from torch_threads import one_torch_thread  # noqa: F401

N_LANES = 4096


@pytest.fixture(autouse=True)
def _off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _cbox(integrator):
    return torch_scenes.cornell_box(16, 16, 2, integrator=integrator,
                                    sphere_subdiv=2)


def _wavefront():
    return torch_wf.render_wavefront(_cbox("path_mis"), seed=3,
                                     n_lanes=N_LANES, sort_rays=True,
                                     device="cpu")


def _batches():
    return torch_render.render(_cbox("whitted"), seed=3, batch=128,
                               device="cpu")


def _recorded(fn):
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    return out, spans.take()


def _by_name(records, name):
    return [r for r in records if r.name == name]


def test_recorder_nests_counts_and_clears():
    assert spans.span("a") is spans.sync("b")      # the shared no-op
    with spans.span("outer"):
        spans.count("n")
    assert spans.take() == {"records": [], "counters": {}}
    spans.enable()
    with spans.span("image"):
        with spans.sync("alive"):
            spans.count("n", 2)
    spans.disable()
    taken = spans.take()
    inner, root = taken["records"]
    assert (root.name, root.parent, inner.name) == ("image", -1,
                                                    "sync.alive")
    assert inner.parent == root.id and inner.image == root.image >= 0
    assert root.start_ns <= inner.start_ns <= inner.end_ns <= root.end_ns
    assert taken["counters"] == {"n": 2, "host_syncs": 1,
                                 "host_syncs.alive": 1}
    assert spans.take() == {"records": [], "counters": {}}


@pytest.mark.parametrize("render", [_wavefront, _batches],
                         ids=["wavefront", "batch"])
def test_off_records_nothing(render):
    render()
    assert spans.take() == {"records": [], "counters": {}}


@pytest.mark.parametrize("render", [_wavefront, _batches],
                         ids=["wavefront", "batch"])
def test_images_bit_equal_on_and_off(render):
    img_off, st_off = render()
    (img_on, st_on), _ = _recorded(render)
    assert np.array_equal(img_on, img_off)
    assert st_on["rays"] == st_off["rays"]


def _assert_nested(records):
    """One image root; every other span inside its parent, with its
    parent's image id; self time never negative."""
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent == -1]
    assert [r.name for r in roots] == ["image"]
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent != -1:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.image == p.image == roots[0].image
    assert min(self_seconds([list(r) for r in records]).values()) >= 0.0


def test_wavefront_spans(monkeypatch):
    reads = []

    class Counted(torch_render._PendingCount):
        def value(self):
            reads.append(1)
            return super().value()

    monkeypatch.setattr(torch_render.Solo, "count", Counted)
    (_, st), taken = _recorded(_wavefront)
    recs, counters = taken["records"], taken["counters"]
    _assert_nested(recs)
    assert len(_by_name(recs, "step")) == st["steps"] == counters["steps"]
    assert len(reads) > 0
    assert counters["host_syncs.pending"] == len(reads) == len(
        _by_name(recs, "sync.pending"))
    names = {r.name for r in recs}
    assert {"prepare", "build", "chunk", "finalize", "gather", "splat",
            "step.vertex", "step.regen", "step.sort", "step.record",
            "sync.copy_out", "sync.rays"} <= names
    # 512 work items fall under an eighth of 4,096 lanes: one shrink
    assert counters["host_syncs.shrink"] == len(_by_name(recs, "shrink"))
    assert len(_by_name(recs, "shrink")) >= 1
    for stage in ("step.vertex", "step.regen", "step.sort", "step.record"):
        assert len(_by_name(recs, stage)) == st["steps"]


def test_batch_spans(monkeypatch):
    sweeps = []
    intersect = whitted.intersect

    def counted(*args):
        sweeps.append(1)
        return intersect(*args)

    monkeypatch.setattr(whitted, "intersect", counted)
    (_, st), taken = _recorded(_batches)
    recs, counters = taken["records"], taken["counters"]
    _assert_nested(recs)
    n_batches = 16 * 16 * 2 // 128
    assert len(_by_name(recs, "batch")) == counters["batches"] == n_batches
    depths = _by_name(recs, "batch.depth")
    # every depth past the first reads alive once (depth 0's lanes are
    # all live); each batch's last read ends its loop
    assert counters["host_syncs.alive"] == len(depths) - n_batches == \
        len(sweeps)
    # mirror and glass spheres: some lanes go deeper than one bounce
    assert len(depths) > 2 * n_batches
    assert counters["host_syncs"] == \
        len(depths) - n_batches + 2                      # + rays, image
    assert {"prepare", "build", "gather", "splat"} <= {r.name for r in recs}
