"""The batch driver's graphed pass (render._GraphedBatch) against the
eager pass of `render.render`: the same images bit for bit, the same
rays and counters, and `batches.graphed` equal to the batches less the
eager first batch of each image.

On the CPU a stand-in for the CUDA graph (_ReplayFn, whose replay runs
the captured function again) drives the static carry, the device q0 and
the per-depth stages through the batch loop; nothing here is a CUDA
graph.  The device-q0 form of the dense splat is held to its int form.
On a card, the tests marked `card` replay real graphs at each ajax
cell's batch width (the benchmark's 541,660-triangle stand-in on the
streamed layout) and also hold the kernels' launch counts to the eager
render's, check that a steady batch makes no synchronising call but
its counted `alive` reads, and that no memory pool grows over five
images.  tests/conftest.py imports JAX, which the card's machine lacks,
and this file does not need it:

    python -m pytest tests/test_torch_batch_graph.py --noconftest -q -m card
"""

import math

import pytest
import torch

from nori_tpu_torch import graphs, render, spans
from nori_tpu_torch import scene as scene_mod
from nori_tpu_torch import scenes_builtin as scenes
from nori_tpu_torch import wavefront as wf
from nori_tpu_torch.accel.sweep import launch_counters
from nori_tpu_torch.core import rng

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


def _ajax(w, h, spp, integrator, **over):
    """The benchmark's ajax configuration as a port scene."""
    from benchmark import manifest as mf
    from benchmark.port import build_scene

    man = mf.load()
    desc = mf.scene_builder("ajax")(
        {**mf.config(man, "ajax"), "width": w, "height": h, **over})
    return build_scene(desc, integrator, spp)


def _tiny_ajax(integrator):
    return _ajax(24, 18, 2, integrator, n_lat=24, n_lon=20)


def _cbox(integrator, w=16, h=12, spp=2):
    return scenes.cornell_box(w, h, spp, integrator=integrator,
                              sphere_subdiv=2)


def _render(monkeypatch, graphed: bool, device, scene, seeds, **kw) -> dict:
    """render.render of `scene` at each seed in turn, graphed or eager
    (graphed on the CPU replays through _ReplayFn): the images and
    stats, the span counters, the captures and the launch counts."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "graph_replay", lambda dev: graphed)
        if graphed and device.type == "cpu":
            m.setattr(graphs, "Graph", _ReplayFn)
        for f in launch_counters().values():
            f.launches = 0
        spans.enable()
        try:
            out = [render.render(scene, seed=s, device=device, **kw)
                   for s in seeds]
        finally:
            spans.disable()
        rec = spans.take()
    return dict(imgs=[img for img, _ in out], st=[st for _, st in out],
                counters=rec["counters"],
                captures=sum(r.name == "capture" for r in rec["records"]),
                launches={k: f.launches
                          for k, f in launch_counters().items()})


def _same(monkeypatch, device, scene, seeds=(5, 2**31 + 7), **kw):
    """The graphed render equals the eager one at each seed; returns
    (eager, graphed)."""
    a = _render(monkeypatch, False, device, scene, seeds, **kw)
    b = _render(monkeypatch, True, device, scene, seeds, **kw)
    for ia, ib, sa, sb in zip(a["imgs"], b["imgs"], a["st"], b["st"]):
        assert ia.tobytes() == ib.tobytes()
        assert sb["rays"] == sa["rays"]
    batches = a["counters"]["batches"]
    assert b["counters"]["batches"] == batches
    assert "batches.graphed" not in a["counters"] and a["captures"] == 0
    # the first batch of each image runs eagerly
    assert b["counters"]["batches.graphed"] == batches - len(seeds)
    # every other counter (host reads, streamed sweeps) as eager: a
    # replay adds what its capture counted.  K5's gate tally (on a card)
    # counts what the walks' order let the gates skip, which varies
    # from run to run: present in both, each positive
    rest = dict(b["counters"])
    del rest["batches.graphed"]
    eager = dict(a["counters"])
    for name in ("sweeps.stream_groups", "sweeps.stream_groups_culled"):
        assert (name in rest) == (name in eager)
        if name in eager:
            assert rest.pop(name) > 0 and eager.pop(name) > 0
    assert rest == eager
    # each image captures its graphs again: depth 0 and the splat at
    # least
    assert b["captures"] >= 2 * len(seeds)
    assert b["launches"] == a["launches"]
    return a, b


CPU_CASES = {
    # streamed layout (K5's plain version), one depth a batch on the
    # microfacet bust; 864 work items in 7 batches, the last ragged
    "ajax_whitted": (lambda: _tiny_ajax("whitted"), dict(batch=128)),
    "ajax_normals": (lambda: _tiny_ajax("normals"), dict(batch=96)),
    # several depths (a depth graph captured the first time a batch
    # reaches it); 384 work items in 3 batches, the last ragged
    "cbox_path_mis": (lambda: _cbox("path_mis"), dict(batch=160)),
}


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_replayed_equals_eager_cpu(monkeypatch, name):
    streamed = name.startswith("ajax")
    if streamed:
        monkeypatch.setattr(scene_mod, "STREAMED_BYTES", SMALL_BOUND)
    make, kw = CPU_CASES[name]
    scene = make()
    assert (scene.compile_arrays()["tri_packed"].shape[0] == 16) == streamed
    a, b = _same(monkeypatch, torch.device("cpu"), scene, **kw)
    assert all(img.mean() > 0.0 for img in a["imgs"])
    if name == "ajax_whitted":
        # one closest and one shadow sweep a batch, replays included
        assert b["counters"]["sweeps.streamed"] == \
            2 * b["counters"]["batches"]
    if name == "cbox_path_mis":
        assert b["captures"] > 2 * 2            # depth graphs past 0


def test_new_seed_captures_again(monkeypatch):
    """One graphed pass over two images: the second image's first batch
    (q0 0, another seed and film) runs eagerly, drops the graphs and
    captures them again, and both films equal the eager pass's."""
    monkeypatch.setattr(graphs, "Graph", _ReplayFn)
    scene = _cbox("whitted")
    sd, spp = render.prepare(scene, None, "cpu")
    total = 16 * 12 * spp
    batch = 128

    def images():
        new_film, pass_fn, finalize = render.make_batch_pass(scene, batch,
                                                             "cpu")
        out = []
        for seed in (3, 4):
            film = new_film()
            for q0 in range(0, total, batch):
                film, _ = pass_fn(sd, film, seed, q0)
            out.append(finalize(film))
        return out, pass_fn

    eager, _ = images()
    monkeypatch.setattr(graphs, "graph_replay", lambda dev: True)
    spans.enable()
    graphed, pass_fn = images()
    spans.disable()
    rec = spans.take()
    assert isinstance(pass_fn, render._GraphedBatch)
    for e, g in zip(eager, graphed):
        assert torch.equal(e, g)
    n_batches = -(-total // batch)
    assert rec["counters"]["batches.graphed"] == 2 * (n_batches - 1)
    captures = sum(r.name == "capture" for r in rec["records"])
    assert captures >= 4 and captures % 2 == 0
    pass_fn.release()


def test_last_batch_releases_the_graphs(monkeypatch):
    """The graphed pass drops its graphs and static carry after the
    image's last batch, whoever drives it; before that it holds both."""
    monkeypatch.setattr(graphs, "Graph", _ReplayFn)
    monkeypatch.setattr(graphs, "graph_replay", lambda dev: True)
    scene = _cbox("whitted")
    sd, spp = render.prepare(scene, None, "cpu")
    total, batch = 16 * 12 * spp, 128
    new_film, pass_fn, _ = render.make_batch_pass(scene, batch, "cpu")
    film = new_film()
    starts = list(range(0, total, batch))
    for q0 in starts[:-1]:
        film, _ = pass_fn(sd, film, 3, q0)
    held = pass_fn._static
    assert held.carry is not None and held._graphs
    film, rays = pass_fn(sd, film, 3, starts[-1])
    assert held.carry is None and not held._graphs
    assert int(rays[0]) > 0


#: 24 x 16 pixels at 3 spp, 1,152 work items in chunks of 264
SPLAT_CHUNK = 264
SPLAT_CASES = {
    "first": 0,
    "middle": 2 * SPLAT_CHUNK,
    # the chunk at 1,056 runs past the last work item
    "ragged_last": 4 * SPLAT_CHUNK,
    # a chunk that starts past the image adds nothing
    "past_the_film": 8 * SPLAT_CHUNK,
}


def _int_form_splat(scene, chunk, film, L_out, seed, q0: int, q_end: int):
    """The dense splat with q0 a Python int, a plain reference: each tap
    adds its row sums into the film's slice that starts at the chunk's
    first pixel, the rows of it that lie in the film."""
    w, _ = scene.camera.output_size
    spp = scene.sampler.sample_count
    rfilter = scene.camera.rfilter
    r = float(rfilter.radius)
    deltas = list(range(math.ceil(-0.5 - r), math.floor(0.5 + r) + 1))
    margin = (1 - deltas[0]) * w - deltas[0] + deltas[-1] + 1
    q = q0 + torch.arange(chunk, dtype=torch.int64)
    in_range = q < q_end
    jitter = rng.uniform2(seed, q, render.JITTER_STREAM)
    rgba = torch.cat([L_out, in_range.to(torch.float32)[:, None]], dim=-1)
    x = (q // spp) % w

    def weights(j):
        return [torch.where(torch.abs(dv - j + 0.5) <= r,
                            rfilter.eval(dv - j + 0.5), 0.0) for dv in deltas]

    wx, wy = weights(jitter[:, 0]), weights(jitter[:, 1])
    for iy, dy in enumerate(deltas):
        for ix, dx in enumerate(deltas):
            ok = (x + dx >= 0) & (x + dx < w) & in_range
            wgt = torch.where(ok, wx[ix] * wy[iy], 0.0)
            sums = torch.sum((rgba * wgt[:, None]).reshape(-1, spp, 4), dim=1)
            start = q0 // spp + dy * w + dx + margin
            rows = max(0, min(sums.shape[0], film.shape[0] - start))
            film[start:start + rows] += sums[:rows]
    return film


@pytest.mark.parametrize("case", sorted(SPLAT_CASES))
def test_device_q0_splat_equals_int_form(case):
    """splat_chunk, its q0 a 0-d device tensor, adds what the slice form
    with an int q0 adds, bit for bit, over a film that already holds
    other chunks' sums, and finalize reads the same image: a chunk past
    the last work item folds its pixels onto rows where they add
    zeros."""
    scene = _ajax(24, 16, 3, "whitted", n_lat=8, n_lon=8)  # Gaussian r 2
    chunk, total = SPLAT_CHUNK, 24 * 16 * 3
    q0 = SPLAT_CASES[case]
    new_film, splat_chunk, finalize = wf.make_dense_splat(scene, chunk,
                                                          "cpu")
    g = torch.Generator().manual_seed(11)
    base = new_film()
    base += torch.rand(base.shape, generator=g)
    L = torch.rand((chunk, 3), generator=g) * 4.0
    a = _int_form_splat(scene, chunk, base.clone(), L, 7, q0, total)
    b = splat_chunk(base.clone(), L, 7, torch.tensor(q0), total)
    assert torch.equal(a, b)
    assert torch.equal(finalize(a), finalize(b))
    if case == "past_the_film":
        assert torch.equal(b, base)
    else:
        assert not torch.equal(b, base)


def test_cpu_batch_pass_is_eager():
    """On the CPU make_batch_pass returns the plain pass."""
    _, pass_fn, _ = render.make_batch_pass(_cbox("normals"), 64, "cpu")
    assert not isinstance(pass_fn, render._GraphedBatch)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
#: the benchmark's batch cells: integrator and batch width, at 2 spp (the
#: cells' warm images)
CELLS = {
    "ajax.whitted": ("whitted", 131072),
    "ajax.normals": ("normals", 131072),
    "ajax.whitted.batch524288": ("whitted", 524288),
}


def _cell_scene(cell, spp=2):
    integrator, _ = CELLS[cell]
    return _ajax(768, 768, spp, integrator)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replayed_equals_eager_on_card(monkeypatch, card, cell):
    a, b = _same(monkeypatch, card, _cell_scene(cell),
                 seeds=(2**31 + 11, 12), batch=CELLS[cell][1])
    assert sum(a["launches"].values())


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_batch_makes_no_sync(card, cell):
    """A steady batch of the cell's stages on the device q0, under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call but
    the host's `alive` reads between depths, which run with the mode
    off."""
    scene = _cell_scene(cell)
    batch = CELLS[cell][1]
    sd, _ = render.prepare(scene, None, card)
    stages = render._BatchStages(scene, batch, card)
    new_film, splat_chunk, _ = wf.make_dense_splat(scene, batch, card)
    film = new_film()
    carry = {"q0": torch.zeros((), dtype=torch.int64, device=card)}

    def one_batch(carry):
        carry = stages.depth(sd, carry, 0, 7)
        for k in range(1, stages.loop.max_depth):
            torch.cuda.set_sync_debug_mode(0)
            live = bool(carry["alive"].any())
            torch.cuda.set_sync_debug_mode("error")
            if not live:
                break
            carry = stages.depth(sd, carry, k, 7)
        splat_chunk(film, stages.values(carry), 7, carry["q0"],
                    stages.total_q)
        return {**carry, "q0": carry["q0"] + batch}

    carry = one_batch(carry)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = one_batch(carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(carry["rays"]) > 0 and int(carry["q0"]) == 2 * batch


@pytest.mark.card
def test_no_pool_grows_over_five_images(card):
    """Five graphed images of ajax.whitted's batch: after each, the
    render has released its graphs, and neither the memory allocated
    nor the memory reserved grows from the second image on."""
    scene = _cell_scene("ajax.whitted")
    after = []
    for i in range(5):
        render.render(scene, seed=100 + i, batch=131072, device=card)
        torch.cuda.synchronize()
        after.append((torch.cuda.memory_allocated(card),
                      torch.cuda.memory_reserved(card)))
    assert all(a == after[1] for a in after[2:]), after
    assert after[1][0] <= after[0][0] and after[1][1] <= after[0][1], after
