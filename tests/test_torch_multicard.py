"""The multi-card entry point (nori_tpu_torch.scripts.multicard) on the
CPU: its dry-run phase end to end at two gloo ranks (one spawn), held to
the JAX package's dryrun_multichip record, and its refusals.

The dry run is `__graft_entry__.dryrun_multichip`'s assertion set at its
own shapes; the script itself holds the sharded living room to the
single-device render (equal rays, the same image bits).  Here the
record it writes is read back: every check passed, and the rays of the
small wavefront and of the living room are the ones the JAX package
traced on its 8-device CPU mesh (MULTICHIP_r05.json): work item q keys
the RNG in both packages, so the rays do not depend on the ranks.
"""

import json
import os
import re

import pytest
import torch

from nori_tpu_torch.scripts import multicard

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRY_CHECKS = {"batch pass film finite", "sharded wavefront finite",
              "living room finite", "rays equal",
              "sharded repeat bit-identical",
              "image bit-equal to one device", "rays on every rank"}


def _jax_dry_run_rays() -> tuple[int, int]:
    """(small wavefront rays, living-room rays) of the JAX package's
    dryrun_multichip, from its record."""
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    wave = re.search(r"sharded wavefront OK \(rays=(\d+)", tail)
    room = re.search(r"rays equal \((\d+)\)", tail)
    return int(wave.group(1)), int(room.group(1))


def test_dry_run_two_gloo_ranks(tmp_path):
    out = tmp_path / "multicard.json"
    assert multicard.main(["--ranks", "2", "--backend", "gloo", "--device",
                           "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] is True and "failed_phase" not in rec
    assert (rec["ranks"], rec["backend"], rec["device"]) == (2, "gloo",
                                                             "cpu")
    assert rec["cpu_count"] == os.cpu_count()
    assert list(rec["phases"]) == ["dry-run"]  # the rest need cards
    dry = rec["phases"]["dry-run"]
    assert set(dry["checks"]) == DRY_CHECKS
    assert all(dry["checks"].values())
    assert [r["device"] for r in dry["rank_devices"]] == ["cpu", "cpu"]
    assert dry["batch_pass"]["finite"] is True
    assert len(dry["batch_pass"]["rays_per_rank"]) == 2
    assert sum(dry["batch_pass"]["rays_per_rank"]) == dry["batch_pass"][
        "rays"] > 0
    room = dry["living_room"]
    assert room["rays"] == room["reference_rays"]
    assert sum(room["rays_per_rank"]) == room["rays"]
    assert min(room["rays_per_rank"]) > 0
    assert room["max_abs_diff"] == 0.0
    assert room["chunk_dev"] == 96 * 54 * 2 // 2
    assert (dry["wavefront"]["rays"], room["rays"]) == _jax_dry_run_rays()


def test_refuses_more_ranks_than_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards"):
        multicard.main(["--ranks", "4", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_refuses_the_cpu_under_nccl(tmp_path):
    with pytest.raises(ValueError, match="nccl"):
        multicard.main(["--ranks", "2", "--device", "cpu", "--out",
                        str(tmp_path / "x.json")])


def test_refuses_gloo_on_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="nccl"):
        multicard.main(["--ranks", "2", "--backend", "gloo", "--out",
                        str(tmp_path / "x.json")])


@pytest.mark.parametrize("ranks, counts", [
    (1, [1]), (2, [1, 2]), (3, [1, 2, 3]), (4, [1, 2, 4]),
    (8, [1, 2, 4, 8])])
def test_rank_counts(ranks, counts):
    assert multicard.rank_counts(ranks) == counts


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_dry_chunk_covers_the_image(ranks):
    """Each rank's share of the dry-run wavefront is whole pixels, and
    the ranks' shares cover every work item."""
    for cfg in (multicard.DRY_WAVE, multicard.DRY_ROOM):
        total = cfg["width"] * cfg["height"] * cfg["spp"]
        chunk = multicard._dry_chunk(cfg["width"], cfg["height"],
                                     cfg["spp"], ranks)
        assert chunk % cfg["spp"] == 0
        assert ranks * chunk >= total > (ranks - 1) * chunk
