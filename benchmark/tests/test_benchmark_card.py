"""On the card: one short run of each cell at a reduced size comes out
correct and reports its metrics (python -m pytest benchmark/tests -m
card)."""

import pytest

from benchmark.run import run_cell

SMALL = {
    "cbox.path_mis": {"config": {"width": 200, "height": 150}},
    "living_room.path_mis": {"config": {"width": 320, "height": 180}},
    "ajax.whitted": {"config": {"width": 192, "height": 192}},
    "ajax.normals": {"config": {"width": 192, "height": 192}},
}


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_on_the_card(card, workload):
    res = run_cell(workload, 2 ** 31 + 11, 1.0, True, device=card,
                   overrides=SMALL[workload])
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "device_idle_pct" in res["metrics"]
