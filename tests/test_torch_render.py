"""The batch driver (nori_tpu_torch.render.render) and the non-path
integrators against nori_tpu.render.render on the CPU.

Both sides run the Moller-Trumbore test (the port's
config.USE_BW_SWEEP False; the JAX package's CPU scan path) at seed 0.
Cases: the Cornell box at 16x16, 2 spp, with every integrator family,
and the ajax composition (the procedural stand-in for ajax.obj at n_lat=32, n_lon=34, 2,110
triangles, with the pa2/pa5 ajax camera) under a lowered streamed
bound, so the port sweeps it with the streamed sweep's plain version
and sorts its shadow rays by their own keys.

Gates: equal ray counts, RMSE < 1e-3, < 1% of pixels off by more than
1e-3, max |diff| < 5e-3 (the image gate of test_torch_wavefront).  The
ajax case renders 8 spp: on the coarse stand-in about 0.4% of whitted's
shadow rays leave the surface at a grazing angle and meet the
neighbouring facet within ~1e-4 of EPSILON, where the two libraries'
roundings of the hit point decide visibility differently; at 2 spp one
such sample moves a pixel by more than 1e-3.
"""

import numpy as np
import pytest

from nori_tpu import film as jax_film
from nori_tpu import render as jax_render
from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu.accel import pallas_mt

from nori_tpu_torch import film as torch_film
from nori_tpu_torch import render as torch_render
from nori_tpu_torch import scene as torch_scene_mod
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import config as torch_config
from nori_tpu_torch.accel import traverse as torch_traverse

from torch_threads import one_torch_thread  # noqa: F401

#: the pa2/pa5 ajax camera (scenes/pa2/ajax-normals.xml)
AJAX_ORIGIN = [-65.6055, 47.5762, 24.3583]
AJAX_TARGET = [-64.8161, 47.2211, 23.8576]
AJAX_UP = [0.299858, 0.934836, -0.190177]
#: emissive quad standing in for scenes/pa5/ajax/light.obj: y 6.3-33.7,
#: 50 degrees around the bust from the camera, facing the bust
AJAX_LIGHT = ([-58.437, 6.3, 35.786], [-58.437, 33.7, 35.786],
              [-38.614, 33.7, 38.436], [-38.614, 6.3, 38.436])
AJAX_RADIANCE = [8.0, 8.0, 8.0]


def ajax_scene(m, width, height, spp, integrator, n_lat=512, n_lon=530):
    """The ajax composition from package m's own helpers: the stand-in
    bust (microfacet, alpha 0.2, kd 0.3) and the emissive quad, seen by
    the ajax camera at fov 30."""
    from importlib import import_module

    pkg = m.__name__.rsplit(".", 1)[0]
    Scene = import_module(pkg + ".scene").Scene
    Transform = import_module(pkg + ".core.transform").Transform
    PropertyList = import_module(pkg + ".props").PropertyList
    md = m.ajax_standin_meshdata(n_lat=n_lat, n_lon=n_lon)
    scene = Scene(PropertyList())
    scene.add_child(m._mesh_obj(
        md.positions, md.faces,
        m._bsdf("microfacet", alpha=0.2, kd=[0.3, 0.3, 0.3]), name="ajax"))
    v, f = m._quad(*AJAX_LIGHT)
    scene.add_child(m._mesh_obj(
        v, f, m._bsdf("diffuse", albedo=[0.0, 0.0, 0.0]),
        emitter=m._area_light(AJAX_RADIANCE), name="light"))
    cam_pl = PropertyList()
    cam_pl.set_integer("width", width)
    cam_pl.set_integer("height", height)
    cam_pl.set_float("fov", 30.0)
    cam_pl.set_transform("toWorld", Transform.lookat(AJAX_ORIGIN,
                                                     AJAX_TARGET, AJAX_UP))
    cam = m.create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)
    samp_pl = PropertyList()
    samp_pl.set_integer("sampleCount", spp)
    scene.add_child(m.create_instance("independent", samp_pl))
    scene.add_child(m.create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


@pytest.fixture(autouse=True)
def _moller_trumbore(monkeypatch):
    monkeypatch.setattr(torch_config, "USE_BW_SWEEP", False)


def _cbox(m, integrator):
    scene = m.cornell_box(16, 16, 2, integrator=integrator, sphere_subdiv=2)
    if integrator == "simple":
        scene.integrator.position = np.array([0.0, 1.8, 0.5])
        scene.integrator.energy = np.array([20.0, 18.0, 15.0])
    return scene


def _assert_gate(img, ref, st, ref_st):
    assert st["rays"] == ref_st["rays"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-3
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) < 0.01
    assert float(diff.max()) < 5e-3
    assert ref.mean() > 0.01


@pytest.mark.parametrize("integrator",
                         ["normals", "simple", "ao", "whitted", "path_mis"])
def test_render_matches_jax(integrator):
    ref, ref_st = jax_render.render(_cbox(jax_scenes, integrator), seed=0)
    img, st = torch_render.render(_cbox(torch_scenes, integrator), seed=0,
                                  device="cpu")
    _assert_gate(img, ref, st, ref_st)


@pytest.mark.parametrize("integrator", ["normals", "whitted"])
def test_ajax_render_matches_jax(monkeypatch, integrator):
    bound = 9 * 1024 * 4   # soups over 1,024 triangles are streamed
    monkeypatch.setattr(pallas_mt, "RESIDENT_VMEM_BUDGET", bound)
    monkeypatch.setattr(torch_scene_mod, "STREAMED_BYTES", bound)
    small = dict(n_lat=32, n_lon=34)
    ref, ref_st = jax_render.render(
        ajax_scene(jax_scenes, 16, 16, 8, integrator, **small), seed=0)
    scene = ajax_scene(torch_scenes, 16, 16, 8, integrator, **small)
    assert scene.compile_arrays()["tri_packed"].shape[0] == 16
    img, st = torch_render.render(scene, seed=0, device="cpu")
    _assert_gate(img, ref, st, ref_st)
    # the bust fills most of the frame
    assert (ref.sum(-1) > 0).mean() > 0.5


def test_sample_pass_film_matches_jax():
    """Per-sample-index passes splatted with the scatter-add film."""
    import jax.numpy as jnp

    js, ts = _cbox(jax_scenes, "normals"), _cbox(torch_scenes, "normals")
    w, h = js.camera.output_size
    jspec = jax_film.FilmSpec.for_filter(w, h, js.camera.rfilter)
    tspec = torch_film.FilmSpec.for_filter(w, h, ts.camera.rfilter)
    assert (tspec.border, tspec.footprint) == (jspec.border, jspec.footprint)
    batch = 96   # the last batch of each sample index is ragged
    jpass = jax_render.make_sample_pass(js, jspec, batch)
    tpass = torch_render.make_sample_pass(ts, tspec, batch, "cpu")
    jsd, tsd = js.compile(), ts.compile("cpu")
    jacc, tacc = jax_film.new_accumulator(jspec), torch_film.new_accumulator(
        tspec, "cpu")
    rays = 0
    for s in range(2):
        for pix0 in range(0, w * h, batch):
            jacc, jdrop, _ = jpass(jsd, jacc, jnp.uint32(0), s,
                                   jnp.uint32(pix0))
            tacc, tdrop, r = tpass(tsd, tacc, 0, s, pix0)
            assert int(tdrop) == int(jdrop) == 0
            rays += int(r)
    assert rays == 2 * batch * -(-w * h // batch)
    ref = np.asarray(jax_film.to_bitmap(jspec, jacc))
    img = torch_film.to_bitmap(tspec, tacc).numpy()
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch_film.merge(tacc, tacc).numpy(),
                               2 * np.asarray(jacc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(16, 16, 32), (100, 70, 32), (64, 48, 8)])
def test_spiral_blocks_match_jax(size):
    w, h, b = size
    assert (list(torch_film.spiral_blocks(w, h, b))
            == list(jax_film.spiral_blocks(w, h, b)))


def test_render_to_files_sends_whitted_to_render(tmp_path):
    scene = _cbox(torch_scenes, "whitted")
    img, st = torch_render.render_to_files(scene, str(tmp_path / "w"),
                                           device="cpu")
    ref, ref_st = torch_render.render(_cbox(torch_scenes, "whitted"),
                                      device="cpu")
    assert "steps" not in st and st["rays"] == ref_st["rays"]
    np.testing.assert_array_equal(img, ref)
    for ext in ("exr", "png"):
        assert (tmp_path / f"w.{ext}").stat().st_size > 0
