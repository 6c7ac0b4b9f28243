"""The wavefront's extras and the CLI's other modes against nori_tpu.

The checkpoint key equals `nori_tpu.wavefront._checkpoint_key`'s digest;
a render cut by max_chunks and resumed is bit-equal to the uncut render
with the same chunk; a mismatched or unreadable checkpoint starts fresh;
check_every changes no sample; on_chunk sees the reference's fractions;
render_to_files writes the reference's files for preview, checkpoint
and view; the CLI tonemaps an EXR to the reference's PNG bytes.
"""

import os

import numpy as np
import pytest

from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import wavefront as jax_wf
from nori_tpu import bitmap as jax_bitmap

from nori_tpu_torch import bitmap as torch_bitmap
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf

from torch_threads import one_torch_thread  # noqa: F401

KEY_SCENES = {
    "cornell_box": lambda m: m.cornell_box(32, 24, spp=4, sphere_subdiv=1),
    "living_room": lambda m: m.living_room(32, 24, 1, detail=1),
}
#: 32 x 24 x 4 = 3072 work items in three chunks
RENDER = dict(n_lanes=1024, chunk=1024, seed=3, device="cpu")


def _cbox():
    return torch_scenes.cornell_box(32, 24, spp=4, sphere_subdiv=1)


@pytest.fixture(scope="module")
def uncut():
    """The uncut renders of seeds 3 and 4 with RENDER's chunk."""
    return {seed: torch_wf.render_wavefront(_cbox(), **dict(RENDER, seed=seed))
            for seed in (3, 4)}


@pytest.mark.parametrize("name", sorted(KEY_SCENES))
@pytest.mark.parametrize("spp, seed, chunk", [(4, 3, 2048), (2, 0, 512)])
def test_checkpoint_key_matches_jax(name, spp, seed, chunk):
    ref = jax_wf._checkpoint_key(KEY_SCENES[name](jax_scenes), spp, seed,
                                 chunk)
    got = torch_wf._checkpoint_key(KEY_SCENES[name](torch_scenes), spp, seed,
                                   chunk)
    assert got == ref


def test_resume_is_bit_equal(tmp_path, uncut):
    ref, st_ref = uncut[3]
    ck = str(tmp_path / "r.ckpt")
    part, st = torch_wf.render_wavefront(_cbox(), checkpoint_path=ck,
                                         max_chunks=1, **RENDER)
    assert st["done"] is False and os.path.exists(ck)
    assert not np.array_equal(part, ref)
    img, st2 = torch_wf.render_wavefront(_cbox(), checkpoint_path=ck,
                                         **RENDER)
    assert st2["done"] is True
    assert not os.path.exists(ck)  # removed on completion
    assert np.array_equal(img, ref)
    assert st2["rays"] == st_ref["rays"]


@pytest.mark.parametrize("kind", ["mismatch", "corrupt", "truncated"])
def test_bad_checkpoint_starts_fresh(tmp_path, uncut, kind):
    ck = str(tmp_path / "m.ckpt")
    # a cut render of seed 3; the render below is of seed 4
    torch_wf.render_wavefront(_cbox(), checkpoint_path=ck, max_chunks=1,
                              **RENDER)
    if kind == "corrupt":
        with open(ck, "wb") as f:
            f.write(b"not a checkpoint")
    elif kind == "truncated":
        data = open(ck, "rb").read()
        with open(ck, "wb") as f:
            f.write(data[: len(data) // 2])
    img, st = torch_wf.render_wavefront(_cbox(), checkpoint_path=ck,
                                        **dict(RENDER, seed=4))
    assert st["done"] and not os.path.exists(ck)
    ref, st_ref = uncut[4]
    assert np.array_equal(img, ref) and st["rays"] == st_ref["rays"]


def test_checkpoint_file_layout(tmp_path):
    """The dump holds the reference's keys: a 0-d string key, the film
    accumulator, the next work item and the rays so far."""
    ck = str(tmp_path / "l.ckpt")
    torch_wf.render_wavefront(_cbox(), checkpoint_path=ck, max_chunks=2,
                              **RENDER)
    with np.load(ck) as d:
        assert sorted(d.files) == ["film", "key", "next_q0", "rays"]
        assert d["key"].shape == () and str(d["key"]) == \
            torch_wf._checkpoint_key(_cbox(), 4, 3, 1024)
        assert int(d["next_q0"]) == 2048 and int(d["rays"]) > 2048
        assert d["film"].dtype == np.float32


def test_check_every_changes_no_sample(uncut):
    ref, st_ref = uncut[3]
    img, st = torch_wf.render_wavefront(_cbox(), check_every=1, **RENDER)
    assert np.array_equal(img, ref) and st["rays"] == st_ref["rays"]
    assert st["steps"] <= st_ref["steps"]


def test_ragged_last_chunk_fills_the_film(uncut):
    """A chunk that does not divide the work items (2048 of 3072): the
    last chunk adds only the film rows it covers; the image agrees with
    the 1024-item chunks' up to the order of the splat's sums."""
    ref, st_ref = uncut[3]
    img, st = torch_wf.render_wavefront(_cbox(), **dict(RENDER, chunk=2048))
    assert st["rays"] == st_ref["rays"]
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_on_chunk_fractions_match_jax():
    kw = dict(n_lanes=1024, chunk=64, seed=3)
    ref, got = [], []
    jax_wf.render_wavefront(jax_scenes.cornell_box(16, 8, spp=2,
                                                   sphere_subdiv=1),
                            on_chunk=lambda img, f: ref.append(f), **kw)
    torch_wf.render_wavefront(
        torch_scenes.cornell_box(16, 8, spp=2, sphere_subdiv=1),
        on_chunk=lambda img, f: got.append((img.shape, f)), device="cpu",
        **kw)
    assert [f for _, f in got] == ref == [0.25, 0.5, 0.75, 1.0]
    assert all(shape == (8, 16, 3) for shape, _ in got)


def test_render_to_files_writes_the_reference_files(tmp_path, capsys):
    """preview, checkpoint and view: the files nori_tpu.render writes
    (the checkpoint removed on completion), the live view drawn."""
    from nori_tpu.render import render_to_files as jax_rtf
    from nori_tpu_torch.render import render_to_files

    files = {}
    for tag, rtf, scenes, extra in (
            ("jax", jax_rtf, jax_scenes, {}),
            ("torch", render_to_files, torch_scenes, {"device": "cpu"})):
        d = tmp_path / tag
        d.mkdir()
        rtf(scenes.cornell_box(8, 6, spp=2, sphere_subdiv=1),
            str(d / "out"), seed=1, preview=True, checkpoint=True,
            view=True, **extra)
        files[tag] = sorted(os.listdir(d))
        assert "rendering... 100%" in capsys.readouterr().out
    assert files["torch"] == files["jax"] == [
        "out.exr", "out.png", "out_preview.png"]


@pytest.mark.parametrize("exposure", [0.0, 1.5])
def test_cli_exr_to_png_matches_jax(tmp_path, exposure, capsys):
    from nori_tpu.main import main as jax_main
    from nori_tpu_torch.main import main

    rng = np.random.RandomState(5)
    img = (rng.rand(13, 17, 3) * 3.0).astype(np.float32)
    exr = str(tmp_path / "img.exr")
    jax_bitmap.write_exr(exr, img)
    argv = ["--exposure", str(exposure)]
    assert jax_main([exr, "-o", str(tmp_path / "jax")] + argv) == 0
    assert main([exr, "-o", str(tmp_path / "torch")] + argv) == 0
    assert "Wrote" in capsys.readouterr().out
    assert ((tmp_path / "torch.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
    # the port's own EXR reader feeds the same bytes
    assert np.array_equal(torch_bitmap.read_exr(exr),
                          jax_bitmap.read_exr(exr))
