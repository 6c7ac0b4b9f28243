"""The streamed sweep's per-warp gate on a card: the gated K5 (and
K5-cull through the same gate) against the dense plain sweep on real
rays, bit for bit.

The rays are those of scripts/stream_inputs.py: on the ajax stand-in
(541,696 triangles) chip_smoke's 32,768 check rays and their shadow
rays, and one whitted batch's 131,072 camera rays and its shadow rays
as traverse.occluded sorts them; on the benchmark's cbox_scan the bounce
and shadow rays of one steady 524,288-lane wavefront step.  Each test
reports how many rays it compared and requires that none differ: for
closest hits the triangle and the bits of t, for any-hit the hit mask.
On the CPU only the helpers run.  tests/conftest.py imports JAX, which
the card's machine lacks, and this file does not need it:

    python -m pytest tests/test_torch_stream_card.py --noconftest -q -m card -s
"""

import os
import sys

import pytest
import torch

from nori_tpu_torch.accel import sweep, traverse

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    """chip_smoke and scripts/stream_inputs, importable from the root."""
    for p in (REPO, os.path.join(REPO, "scripts")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import chip_smoke
    import stream_inputs
    return chip_smoke, stream_inputs


def differing(got, ref, rays, any_hit: bool) -> tuple[int, int]:
    """(rays compared, rays whose answer differs): the live rays; any-hit
    compares hit masks, closest hits the triangle and, where both hit,
    the bits of t."""
    live = rays[6] <= rays[7]
    (t, i), (tp, ip) = got, ref
    if any_hit:
        bad = (i >= 0) != (ip >= 0)
    else:
        both = (i >= 0) & (ip >= 0)
        bad = (i != ip) | (both & (t.view(torch.int32)
                                   != tp.view(torch.int32)))
    return int(live.sum()), int((bad & live).sum())


def test_differing_counts_rays():
    """The helper itself, on the CPU: a changed triangle, a changed t bit
    and a changed any-hit answer count; a dead lane does not."""
    rays = torch.zeros((8, 4))
    rays[7] = 1.0
    rays[6, 3] = 2.0                       # lane 3 dead
    tp = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ip = torch.tensor([0, 1, -1, 5], dtype=torch.int32)
    t = tp.clone()
    t[1] = torch.nextafter(t[1], torch.tensor(9.0))
    i = ip.clone()
    i[0], i[3] = 7, 6
    assert differing((t, i), (tp, ip), rays, False) == (3, 2)
    i[2] = 4
    assert differing((t, i), (tp, ip), rays, True) == (3, 1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on a card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def ajax(card):
    cs, si = _modules()
    return si.ajax_inputs(cs, card)


@pytest.fixture(scope="module")
def cbox_scan(card):
    _, si = _modules()
    return si.cbox_scan_inputs(card)


def _check(label, sd, op, use_bw, rays, any_hit, call):
    keys, bits = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    got = call(op, keys, bits, rays, any_hit)
    ref = sweep.stream_sweep_plain(op, rays, any_hit, use_bw)
    n, bad = differing(got, ref, rays, any_hit)
    print(f"{label}: {n} rays compared, {bad} differ, "
          f"{int((ref[1] >= 0).sum())} hits")
    assert n > 0 and bad == 0


def _k5(sd, use_bw):
    return lambda op, keys, bits, rays, any_hit: sweep.stream_sweep(
        op, keys, bits, rays, any_hit, use_bw, sub_boxes=sd.tri_sub_boxes)


AJAX_QUERIES = {
    # label: (operand, rays, any-hit)
    "bw closest": ("bw", "rays", False),
    "mt closest": ("mt", "rays", False),
    "bw any-hit": ("bw", "shadow", True),
    "mt any-hit": ("mt", "shadow", True),
    "bw closest batch": ("bw", "rays_b", False),
    "bw any-hit sorted batch": ("bw", "srt", True),
}


@pytest.mark.card
@pytest.mark.parametrize("label", sorted(AJAX_QUERIES))
def test_gated_k5_equals_plain_on_ajax(ajax, label):
    kind, name, any_hit = AJAX_QUERIES[label]
    use_bw = kind == "bw"
    op = ajax.sd.tri_bw if use_bw else ajax.sd.tri_packed
    _check(f"ajax K5 {label}", ajax.sd, op, use_bw, getattr(ajax, name),
           any_hit, _k5(ajax.sd, use_bw))


@pytest.mark.card
@pytest.mark.parametrize("cull_t", [128, 64])
@pytest.mark.parametrize("any_hit", [False, True])
def test_culled_k5_equals_plain_on_ajax(ajax, cull_t, any_hit):
    """K5-cull through the same gate at its own sub-blocks, with the
    boxes traverse builds for config.STREAM_CULL_T."""
    sd = ajax.sd
    boxes = traverse.cull_boxes(sd, cull_t)
    assert boxes.shape == (sd.tri_packed.shape[1] // cull_t, 8)
    _check(f"ajax K5-cull {cull_t} {'any-hit' if any_hit else 'closest'}",
           sd, sd.tri_packed, False, ajax.shadow if any_hit else ajax.rays,
           any_hit,
           lambda op, keys, bits, rays, ah: sweep.stream_sweep_culled(
               op, keys, bits, rays, ah, cull_t, sub_boxes=boxes))


@pytest.mark.card
@pytest.mark.parametrize("any_hit", [False, True])
def test_gated_k5_equals_plain_on_cbox_scan_step(cbox_scan, any_hit):
    """One steady cbox_scan step's bounce rays (closest) and sorted
    shadow rays (any-hit), as the benchmark cell's step hands them to
    K5."""
    sd = cbox_scan.sd
    rays = cbox_scan.shadow if any_hit else cbox_scan.closest
    _check(f"cbox_scan step K5 {'any-hit' if any_hit else 'closest'}", sd,
           sd.tri_bw, True, rays, any_hit, _k5(sd, True))


@pytest.mark.card
def test_gate_tally_counts(ajax):
    """The tally of one gated sweep: every warp sub-block is counted
    once, tested or culled, and on the camera rays the gate culls."""
    sd, rays = ajax.sd, ajax.rays
    keys, bits = sweep.ray_tile_entry_keys(sd.tri_tile_bounds, rays)
    tally = torch.zeros((2,), dtype=torch.int64, device=rays.device)
    visits = torch.zeros((rays.shape[1] // 256,), dtype=torch.int32,
                         device=rays.device)
    sweep.stream_sweep(sd.tri_bw, keys, bits, rays, False, True,
                       visits=visits, sub_boxes=sd.tri_sub_boxes,
                       tally=tally)
    tested, culled = tally.tolist()
    print(f"ajax K5 bw closest gate: {tested} warp sub-blocks tested, "
          f"{culled} culled ({100 * culled / (tested + culled):.1f}%)")
    assert tested == int(visits.sum()) and tested > 0 and culled > 0
