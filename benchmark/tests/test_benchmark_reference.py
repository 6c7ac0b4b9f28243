"""The plain reference reproduces the program's images at a tiny size on
the CPU, and the comparison that decides `correct` passes them and fails
degraded ones and the bfloat16 control."""

import numpy as np
import pytest
import torch

from benchmark import check, manifest as mf, port
from benchmark.reference import bvh
from benchmark.reference.render import Reference

SEED = 2 ** 33 + 5
CORNERS = [(0, 0), (20, 9)]
SIZE = 12
ITEMS = [(SEED, x, y) for x, y in CORNERS]


def _desc(config, **over):
    cfg = {**mf.config(mf.load(), config), **over}
    return mf.scene_builder(config)(cfg)


def _soup(desc):
    v0, e1, e2 = [], [], []
    for m in desc.meshes:
        p = [m.positions[m.faces[:, k]].astype(np.float64) for k in range(3)]
        v0.append(p[0]), e1.append(p[1] - p[0]), e2.append(p[2] - p[0])
    return [np.concatenate(a).astype(np.float32) for a in (v0, e1, e2)]


@pytest.mark.parametrize("config,over", [
    ("cbox", {}), ("living_room", {"detail": 3}),
    ("ajax", {"n_lat": 96, "n_lon": 90})])
def test_bvh_order_is_the_programs(config, over):
    """The reference's level-by-level build orders the soup as the
    program's scene compile does (whose order the emitter CDF follows)."""
    from nori_tpu_torch.accel.bvh import build_bvh

    soup = _soup(_desc(config, **over))
    order, _ = build_bvh(*soup)
    assert np.array_equal(bvh.build(*soup).order, order)


@pytest.fixture(scope="module")
def rendered():
    torch.set_num_threads(4)
    desc = _desc("cbox", width=40, height=30)
    out = {}
    for integ, spp in (("path_mis", 4), ("whitted", 4)):
        traffic = {"integrator": integ, "spp": spp, "n_lanes": 4096,
                   "batch": 4096}
        img, _ = port.render_image(port.build_scene(desc, integ, spp),
                                   traffic, SEED, "cpu")
        mine = np.stack([img[y:y + SIZE, x:x + SIZE] for x, y in CORNERS])
        want = Reference(desc, traffic, "cpu").blocks(ITEMS, SIZE)
        low = Reference(desc, traffic, "cpu", lowp=True).blocks(
            ITEMS, SIZE)
        out[integ] = (mine, want, low)
    return out


LIMITS = {"err_p50": 1e-5, "err_p90": 1e-4, "img_p50_max": 1e-4}


def _numbers(mine, want):
    """The numbers compared, with the blocks taken as one image."""
    err = check.pixel_errors(mine, want)
    return check.numbers({"err": err, "by_image": {0: err.reshape(-1)}})


@pytest.mark.parametrize("integ", ["path_mis", "whitted"])
def test_program_image_passes(rendered, integ):
    mine, want, _ = rendered[integ]
    vals = _numbers(mine, want)
    assert vals["err_p90"] < 1e-6
    assert check.judge(vals, LIMITS)


@pytest.mark.parametrize("integ", ["path_mis", "whitted"])
@pytest.mark.parametrize("degrade", ["scale", "noise", "nan", "control"])
def test_degraded_image_fails(rendered, integ, degrade):
    mine, want, low = rendered[integ]
    rng = np.random.default_rng(0)
    bad = {"scale": mine * 1.001,
           "noise": mine * (1 + 0.01 * rng.standard_normal(mine.shape)),
           "nan": np.where(np.arange(mine.size).reshape(mine.shape) % 2,
                           np.nan, mine),
           "control": low}[degrade]
    vals = _numbers(bad, want)
    assert not check.judge(vals, LIMITS)


def test_choose_takes_whole_images():
    assert check.choose(7, 2, 3, 10) == [(i, b) for i in range(2)
                                         for b in range(3)]
    pairs = check.choose(7, n_images=9, per_image=4, cap=5)
    images = sorted({i for i, _ in pairs})
    assert len(images) == 5 and set(images) <= set(range(9))
    assert pairs == [(i, b) for i in images for b in range(4)]
    assert check.choose(7, 9, 4, 5) == pairs
    assert check.mix_seed(2 ** 40, 0) != check.mix_seed(2 ** 40, 1)
    assert 0 <= check.mix_seed(2 ** 62 + 3, 9) < 2 ** 32
