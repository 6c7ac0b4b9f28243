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
makes no synchronising call.  tests/conftest.py imports JAX, which the
card's machine lacks, and this file does not need it:

    python -m pytest tests/test_torch_graph.py --noconftest -q -m card
"""

import pytest
import torch

from nori_tpu_torch import config, spans
from nori_tpu_torch import scenes_builtin as scenes
from nori_tpu_torch import wavefront as wf
from nori_tpu_torch.accel.sweep import launch_counters
from nori_tpu_torch.integrators.path import MIS
from nori_tpu_torch.render import prepare


class _ReplayFn:
    """wavefront._Graph on the CPU: capture records fn, replay runs it."""

    def __init__(self, fn, device):
        self.fn = fn

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the renders here are small, and on a host
    shared by many test processes a thread pool sized to the host's
    cores slows them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
            m.setattr(wf, "graph_replay", lambda dev: False)
        elif device.type == "cpu":
            m.setattr(wf, "graph_replay", lambda dev: True)
            m.setattr(wf, "_Graph", _ReplayFn)
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


def test_graph_replay_decides_by_device_and_backend(monkeypatch):
    assert not wf.graph_replay(torch.device("cpu"))
    for mode, want in (("pallas", True), ("scan", False), ("bvh", False)):
        monkeypatch.setattr(config, "accel_mode", mode)
        assert wf.graph_replay(torch.device("cuda")) is want


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
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_replayed_equals_eager_on_card(monkeypatch, card, name):
    make, kw = CARD_CASES[name]
    a, b = _same(monkeypatch, card, make, seed=2**31 + 11, **kw)
    assert b["launches"] == a["launches"] and sum(a["launches"].values())
    if name == "cbox_cascade":
        assert b["entries"] == b["captures"] == 3


@pytest.mark.card
def test_checkpoint_resumed_replayed_equals_eager_on_card(monkeypatch,
                                                          card, tmp_path):
    _resumed(monkeypatch, card, CARD_CASES["cbox_chunks"][0],
             str(tmp_path / "c.ckpt.npz"), seed=9, n_lanes=8192,
             chunk=16384)


CELL_SCENES = {
    # the benchmark's wavefront cells: scene at spp, lanes
    "living_room.path_mis": (lambda spp: scenes.living_room(
        1280, 720, spp, detail=5), 524288),
    "cbox.path_mis": (lambda spp: scenes.cornell_box(800, 600, spp), 131072),
}


@pytest.mark.card
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("cell", sorted(CELL_SCENES))
def test_cell_step_makes_no_sync(card, cell, merged):
    """Steady-state eager steps of the cell's scene under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call."""
    make, n = CELL_SCENES[cell]
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
    """The cell's warm image (1 spp at its lanes) captures a graph at
    each of the cascade's three widths and equals the eager image."""
    make, n = CELL_SCENES[cell]
    a, b = _same(monkeypatch, card, lambda: make(1), seed=3, n_lanes=n)
    assert b["entries"] == b["captures"] == 3
