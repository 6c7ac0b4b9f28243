"""The streamed cells: cbox_scan.path_mis (the Cornell box with the
541,660-triangle stand-in, path-traced through the wavefront) and
ajax.whitted.batch524288 (ajax.whitted at four times the batch).

On the CPU at a tiny size, the port's streamed bound is lowered so that
the tiny scene still takes the streamed layout (16-row operands over
512-triangle slabs), as tests/test_torch_stream.py lowers it: a run
comes out `correct` against the plain reference, and the same run with
its images scaled by 1.001 does not.  On the card (`-m card`), one short
run of each cell at a reduced size, with the full triangle count.
"""

import pytest
import torch

from benchmark import manifest as mf
from benchmark.run import run_cell

SEED = 2 ** 32 + 99
#: soups over 512 padded triangles take the streamed layout
SMALL_BOUND = 9 * 512 * 4
TINY = {
    "cbox_scan.path_mis": {"config": {"width": 24, "height": 18,
                                      "n_lat": 24, "n_lon": 20},
                           "cell": {"spp": 2, "n_lanes": 4096}},
    "ajax.whitted.batch524288": {"config": {"width": 24, "height": 24,
                                            "n_lat": 24, "n_lon": 20},
                                 "cell": {"spp": 2, "batch": 4096}},
}
#: reduced images, every triangle
SMALL = {
    "cbox_scan.path_mis": {"config": {"width": 200, "height": 150}},
    "ajax.whitted.batch524288": {"config": {"width": 192, "height": 192}},
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_bound(monkeypatch):
    from nori_tpu_torch import scene

    monkeypatch.setattr(scene, "STREAMED_BYTES", SMALL_BOUND)


def _run(workload):
    return run_cell(workload, SEED, 0.0, False, device="cpu",
                    overrides=TINY[workload])


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_scene_is_streamed(small_bound, workload):
    from benchmark import port

    man = mf.load()
    config = mf.workload(man, workload)["config"]
    desc = mf.scene_builder(config)(
        {**mf.config(man, config), **TINY[workload]["config"]})
    scene = port.build_scene(desc, mf.cell(workload)["integrator"], 2)
    arrays = scene.compile_arrays()
    assert arrays["tri_packed"].shape[0] == 16
    assert arrays["tri_tile_bounds"].shape[0] == \
        arrays["tri_packed"].shape[1] // 512 >= 2


def test_full_scene_counts_its_triangles():
    """The configuration's own size: cbox's 14 room triangles and the
    stand-in's 541,660, as its file says."""
    man = mf.load()
    cfg = mf.config(man, "cbox_scan")
    desc = mf.scene_builder("cbox_scan")(cfg)
    assert sum(m.faces.shape[0] for m in desc.meshes) == cfg["triangles"]
    bust = [m for m in desc.meshes if m.name == "ajax"][0]
    lo, hi = bust.positions.min(0), bust.positions.max(0)
    assert 0.0 < lo[1] < 0.01 and 1.15 < hi[1] < 1.25
    assert max(abs(lo[0] + hi[0]), abs(lo[2] + hi[2])) < 0.01


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(small_bound, workload):
    res = _run(workload)
    assert res["correct"] is True and res["failed"] == 0, res["check"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_scaled_image_is_not_correct(small_bound, monkeypatch, workload):
    from benchmark import port

    render_image = port.render_image

    def scaled(scene, traffic, seed, device):
        img, st = render_image(scene, traffic, seed, device)
        return img * 1.001, st

    monkeypatch.setattr(port, "render_image", scaled)
    assert _run(workload)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_on_the_card(card, workload):
    res = run_cell(workload, 2 ** 31 + 11, 1.0, True, device=card,
                   overrides=SMALL[workload])
    assert res["correct"] is True, res["check"]
    assert res["device"]["busy_s"] > 0
    assert "device_idle_pct" in res["metrics"]
    if workload == "cbox_scan.path_mis":
        assert res["metrics"]["stream_ms_per_step"]["value"] > 0
