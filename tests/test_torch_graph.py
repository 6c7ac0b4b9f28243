"""The wavefront's graphed step (wavefront._GraphedStep) against the
eager step: the same images bit for bit, the same rays and steps, and
`steps.graphed` equal to the steps less the first step of each stage in
each chunk, which runs eagerly.

On the CPU a stand-in for the CUDA graph (_ReplayFn, whose replay runs
the captured function again) drives the static carry, the record log
that every chunk refills, and the eager first steps through the chunk
loop; nothing here is a CUDA graph.  On a card, the tests marked `card`
replay real graphs and also hold the kernels' launch counts to the
eager render's, and check that a step of each benchmark cell's scene
makes no synchronising call.  The streamed layout (the benchmark's
cbox_scan: the Cornell box with a 541,660-triangle stand-in) runs K5 and
the shadow query's K3 presort inside the captured step; on the CPU its
tiny version takes that layout under a lowered bound.  tests/conftest.py
imports JAX, which the card's machine lacks, and this file does not
need it:

    python -m pytest tests/test_torch_graph.py --noconftest -q -m card
"""

import pytest
import torch

from nori_tpu_torch import config, graphs, spans
from nori_tpu_torch import scene as scene_mod
from nori_tpu_torch import scenes_builtin as scenes
from nori_tpu_torch import wavefront as wf
from nori_tpu_torch.accel.sweep import launch_counters
from nori_tpu_torch.integrators.path import MIS
from nori_tpu_torch.render import prepare

from torch_threads import one_torch_thread  # noqa: F401


#: soups over 512 padded triangles take the streamed layout
SMALL_BOUND = 9 * 512 * 4


class _ReplayFn:
    """graphs.Graph on the CPU: capture records fn, replay runs it."""

    def __init__(self, fn, device):
        self.fn = fn

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs replay only on a card")
    return torch.device("cuda")


def _cbox(w=16, h=16, spp=2):
    return scenes.cornell_box(w, h, spp, sphere_subdiv=2)


def _room(w=16, h=16, spp=2, detail=1):
    return scenes.living_room(w, h, spp, detail=detail)


def _cbox_scan(w, h, spp, **over):
    """The benchmark's cbox_scan configuration as a port scene."""
    from benchmark import manifest as mf
    from benchmark.port import build_scene

    man = mf.load()
    desc = mf.scene_builder("cbox_scan")(
        {**mf.config(man, "cbox_scan"), "width": w, "height": h, **over})
    return build_scene(desc, "path_mis", spp)


def _eager_entries(records) -> int:
    """Steps that begin a stage in a chunk: the first `step` span after
    a `chunk` span opens or a `shrink` span closes."""
    events = sorted([(r.start_ns, 1, r.name) for r in records
                     if r.name == "chunk"]
                    + [(r.end_ns, 0, r.name) for r in records
                       if r.name == "shrink"]
                    + [(r.start_ns, 2, r.name) for r in records
                       if r.name == "step"])
    fresh, n = False, 0
    for _, _, name in events:
        if name == "step":
            n += fresh
            fresh = False
        else:
            fresh = True
    return n


def _render(monkeypatch, graphed: bool, device, make, **kw) -> dict:
    """One render_wavefront, graphed or eager (graphed on the CPU
    replays through _ReplayFn): its image and stats, the span counters,
    the eager stage entries, the captures and the launch counts."""
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(graphs, "graph_replay", lambda dev: False)
        elif device.type == "cpu":
            m.setattr(graphs, "graph_replay", lambda dev: True)
            m.setattr(graphs, "Graph", _ReplayFn)
        for f in launch_counters().values():
            f.launches = 0
        spans.enable()
        try:
            img, st = wf.render_wavefront(make(), device=device, **kw)
        finally:
            spans.disable()
        rec = spans.take()
    return dict(img=img, st=st, counters=rec["counters"],
                entries=_eager_entries(rec["records"]),
                captures=sum(r.name == "capture" for r in rec["records"]),
                shrinks=sum(r.name == "shrink" for r in rec["records"]),
                launches={k: f.launches
                          for k, f in launch_counters().items()})


def _same(monkeypatch, device, make, **kw):
    a = _render(monkeypatch, False, device, make, **kw)
    b = _render(monkeypatch, True, device, make, **kw)
    assert a["img"].tobytes() == b["img"].tobytes()
    for k in ("rays", "steps"):
        assert b["st"][k] == a["st"][k]
    assert b["counters"]["steps"] == a["counters"]["steps"] == \
        a["st"]["steps"]
    assert "steps.graphed" not in a["counters"] and a["captures"] == 0
    assert b["entries"] >= 1 and b["captures"] >= 1
    assert b["counters"]["steps.graphed"] == b["st"]["steps"] - b["entries"]
    # a step's own counters: on a card a replay adds what capture counted
    assert b["counters"].get("sweeps.streamed") == \
        a["counters"].get("sweeps.streamed")
    return a, b


CPU_CASES = {
    # two widths (4,096 and 1,024 lanes), the exact-bitmask sort key
    "cbox": (_cbox, dict(n_lanes=4096, sort_rays=True)),
    "cbox_merged": (_cbox, dict(n_lanes=4096, sort_rays=True,
                                merged=True)),
    # four chunks: every chunk's init refills the static carry
    "cbox_chunks": (_cbox, dict(n_lanes=4096, sort_rays=True, chunk=128)),
    "room_chunks_merged": (_room, dict(n_lanes=4096, chunk=256,
                                       merged=True)),
}


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_replayed_equals_eager_cpu(monkeypatch, name):
    make, kw = CPU_CASES[name]
    a, b = _same(monkeypatch, torch.device("cpu"), make, seed=5, **kw)
    assert b["counters"]["steps.graphed"] > 0
    if "chunk" in kw:
        assert b["entries"] >= 512 // kw["chunk"]
    assert a["img"].mean() > 0.0


def test_streamed_replayed_equals_eager_cpu(monkeypatch):
    """A tiny cbox_scan on the streamed layout: replayed equals eager,
    and `sweeps.streamed` counts a closest and a shadow sweep a step
    both ways."""
    monkeypatch.setattr(scene_mod, "STREAMED_BYTES", SMALL_BOUND)

    def make():
        return _cbox_scan(24, 18, 2, n_lat=24, n_lon=20)

    assert make().compile_arrays()["tri_packed"].shape[0] == 16
    a, b = _same(monkeypatch, torch.device("cpu"), make, seed=5,
                 n_lanes=4096, sort_rays=True)
    assert b["counters"]["steps.graphed"] > 0
    assert a["counters"]["sweeps.streamed"] == \
        b["counters"]["sweeps.streamed"] == 2 * a["st"]["steps"]
    # the plain sweep has no gate, and no tally to read
    assert "sweeps.stream_groups" not in a["counters"]
    assert a["img"].mean() > 0.0


class _CaptureRunsFn:
    """graphs.Graph's Python side: capture runs fn once (its host
    code, counters included), a replay runs no Python."""

    def __init__(self, fn, device):
        fn()

    def replay(self):
        pass

    def reset(self):
        pass


def test_replay_adds_what_capture_counted(monkeypatch):
    """A step's spans counters: an eager step counts them, capture
    takes back what it counted, and each replay adds it."""
    monkeypatch.setattr(graphs, "Graph", _CaptureRunsFn)

    def step(sd, carry, seed):
        spans.count("sweeps.streamed", 2)
        return ({"x": carry[0]["x"] + 1},)

    graphed = wf._GraphedStep(step, torch.device("cpu"))
    spans.enable()
    carry = graphed(None, ({"x": torch.zeros(())},), 1)   # eager
    assert spans.counters()["sweeps.streamed"] == 2
    for k in range(3):                                      # capture, replays
        assert graphed(None, carry, 1) is carry
        assert spans.counters()["sweeps.streamed"] == 4 + 2 * k
    assert spans.counters()["steps.graphed"] == 3
    graphed(None, carry, 2)                                 # a new seed
    assert spans.counters()["sweeps.streamed"] == 10


def _resumed(monkeypatch, device, make, path, **kw):
    """A checkpointed render cut after its first chunk and resumed,
    graphed, against the uncut eager render."""
    ref = _render(monkeypatch, False, device, make, **kw)
    first = _render(monkeypatch, True, device, make, checkpoint_path=path,
                    max_chunks=1, **kw)
    assert not first["st"]["done"]
    rest = _render(monkeypatch, True, device, make, checkpoint_path=path,
                   **kw)
    assert rest["st"]["done"]
    assert rest["img"].tobytes() == ref["img"].tobytes()
    assert rest["st"]["rays"] == ref["st"]["rays"]


def test_checkpoint_resumed_replayed_equals_eager_cpu(monkeypatch,
                                                      tmp_path):
    _resumed(monkeypatch, torch.device("cpu"), _cbox,
             str(tmp_path / "c.ckpt.npz"), seed=2, n_lanes=4096,
             sort_rays=True, chunk=128)


@pytest.mark.parametrize("form", ["dict", "tuple"])
def test_carry_into_writes_in_place(form):
    """graphs.carry_into copies each tensor of a carry into the static
    carry's, leaves a tensor the two share, and refuses other keys or
    another host value."""
    shared = torch.zeros(2)

    def carry(x, primed=True):
        state = {"x": x, "primed": primed}
        return state if form == "dict" else (state, shared)

    static = carry(torch.zeros(3))
    x = static["x"] if form == "dict" else static[0]["x"]
    graphs.carry_into(static, carry(torch.arange(3.0)))
    assert torch.equal(x, torch.arange(3.0))
    assert (static if form == "dict" else static[0])["x"] is x
    with pytest.raises(ValueError):
        graphs.carry_into(static, carry(torch.ones(3), primed=False))
    bad = {"y": torch.ones(3), "primed": True}
    with pytest.raises(ValueError):
        graphs.carry_into(static, bad if form == "dict" else (bad, shared))


def test_graph_replay_decides_by_device_and_backend(monkeypatch):
    assert not graphs.graph_replay(torch.device("cpu"))
    for mode, want in (("pallas", True), ("scan", False), ("bvh", False)):
        monkeypatch.setattr(config, "accel_mode", mode)
        assert graphs.graph_replay(torch.device("cuda")) is want


def test_cpu_stepper_is_eager():
    """On the CPU make_wavefront_stepper returns the plain step, and
    release_graphs finds nothing to release."""
    _, step, _, _ = wf.make_wavefront_stepper(_cbox(), MIS, 4096, 4096,
                                              device="cpu")
    assert not isinstance(step, wf._GraphedStep)
    wf.release_graphs((None, [(step, None, None)], None))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
CARD_CASES = {
    # 262,144 work items on a 65,536-lane pool, whose drain takes the
    # full shrink cascade, 65,536 -> 8,192 -> 1,024 lanes
    "cbox_cascade": (lambda: _cbox(128, 128, 16), dict(n_lanes=65536)),
    "room": (lambda: _room(160, 120, 4, detail=1), dict()),
    "room_merged": (lambda: _room(160, 120, 4, detail=1),
                    dict(merged=True)),
    "cbox_chunks": (lambda: _cbox(128, 128, 4),
                    dict(n_lanes=8192, chunk=16384)),
    # the streamed layout at its full 541,674 triangles: K5 and the K3
    # shadow presort in the captured step, through the full cascade.
    # Past depth 3 its paths die fast (roulette on a throughput that the
    # dark bust and the open front keep low): read every 8 or even 4
    # steps, one stale count takes both shrinks at once
    "cbox_scan_cascade": (lambda: _cbox_scan(128, 128, 16),
                          dict(n_lanes=65536, check_every=2)),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_replayed_equals_eager_on_card(monkeypatch, card, name):
    make, kw = CARD_CASES[name]
    a, b = _same(monkeypatch, card, make, seed=2**31 + 11, **kw)
    assert b["launches"] == a["launches"] and sum(a["launches"].values())
    if name.endswith("_cascade"):
        assert b["shrinks"] == 2
        assert b["entries"] == b["captures"] == 3
    if name == "cbox_scan_cascade":
        # K5's gate tally, read once an image: a replayed sweep adds to
        # it on the card (the counts vary with the items' order)
        for r in (a, b):
            assert r["counters"]["sweeps.stream_groups"] > 0
            assert r["counters"]["sweeps.stream_groups_culled"] > 0


@pytest.mark.card
def test_checkpoint_resumed_replayed_equals_eager_on_card(monkeypatch,
                                                          card, tmp_path):
    _resumed(monkeypatch, card, CARD_CASES["cbox_chunks"][0],
             str(tmp_path / "c.ckpt.npz"), seed=9, n_lanes=8192,
             chunk=16384)


CELL_SCENES = {
    # the benchmark's wavefront cells: scene at spp, lanes, and the widths
    # of the cascade that the warm image steps at
    "living_room.path_mis": (lambda spp: scenes.living_room(
        1280, 720, spp, detail=5), 524288, 3),
    "cbox.path_mis": (lambda spp: scenes.cornell_box(800, 600, spp), 131072,
                      3),
    # 480,000 items fill the pool once and its paths die fast: the read
    # after the first window qualifies for both shrinks, so no step runs
    # at 65,536 lanes
    "cbox_scan.path_mis": (lambda spp: _cbox_scan(800, 600, spp), 524288,
                           2),
}


@pytest.mark.card
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("cell", sorted(CELL_SCENES))
def test_cell_step_makes_no_sync(card, cell, merged):
    """Steady-state eager steps of the cell's scene under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call."""
    make, n, _ = CELL_SCENES[cell]
    scene = make(32)
    sd, spp = prepare(scene, None, card)
    w, h = scene.camera.output_size
    init, step, _, _ = wf.make_wavefront_stepper(
        scene, MIS, n, 64 * n, device=card, merged=merged, graph=False)
    carry = step(sd, init(7, 0, w * h * spp), 7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            carry = step(sd, carry, 7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(carry[4]) > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELL_SCENES))
def test_cell_captures_every_width(monkeypatch, card, cell):
    """The cell's warm image (1 spp at its lanes) drains through the
    cascade to its narrowest width, captures a graph at each width it
    steps at, and equals the eager image."""
    make, n, widths = CELL_SCENES[cell]
    a, b = _same(monkeypatch, card, lambda: make(1), seed=3, n_lanes=n)
    assert b["shrinks"] == 2
    assert b["entries"] == b["captures"] == widths
