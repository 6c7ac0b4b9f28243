"""nori_tpu_torch host layer against nori_tpu: scene compilation,
SceneData round trip, image output bytes, the CLI (a whitted scene
rendered to EXR/PNG, EXR viewing refused as not yet ported), and the
jax-free import."""

import os
import subprocess
import sys

import numpy as np
import pytest

from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import bitmap as jax_bitmap

import nori_tpu_torch
from nori_tpu_torch import bitmap as torch_bitmap
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch.scene import SceneData, scene_data_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "living_room": lambda m: m.living_room(32, 32, 1, detail=3),
    "cornell_box": lambda m: m.cornell_box(32, 32, 1, sphere_subdiv=2),
}
#: JAX SceneData fields the port does not carry: the MXU operand (read
#: by nothing in the port) and the BSDF table (packed in mesh_attr)
NOT_CARRIED = {"tri_mxu", "bsdf"}


def _jax_arrays(name):
    sd = SCENES[name](jax_scenes).compile()
    return {f: np.asarray(getattr(sd, f)) for f in sd._fields
            if f not in NOT_CARRIED}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_bit_equal(name):
    ref = _jax_arrays(name)
    got = SCENES[name](torch_scenes).compile_arrays()
    assert set(got) == set(ref)
    for k in ref:
        a, b = np.asarray(got[k]), ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_data_from_numpy_round_trip(name):
    ref = _jax_arrays(name)
    sd = scene_data_from_numpy(ref, "cpu")
    assert isinstance(sd, SceneData)
    for k, a in ref.items():
        t = getattr(sd, k)
        assert t.is_contiguous(), k
        assert t.numpy().tobytes() == np.ascontiguousarray(a).tobytes(), k
        assert tuple(t.shape) == a.shape, k
    own = SCENES[name](torch_scenes).compile("cpu")
    for k in ref:
        assert bool((getattr(own, k) == getattr(sd, k)).all()), k


@pytest.mark.parametrize("half", [True, False])
def test_image_bytes_equal(tmp_path, half):
    rng = np.random.RandomState(3)
    img = (rng.rand(19, 23, 3) * 4.0).astype(np.float32)
    for mod, tag in ((jax_bitmap, "jax"), (torch_bitmap, "torch")):
        mod.write_exr(str(tmp_path / f"{tag}.exr"), img, half=half)
        mod.write_png(str(tmp_path / f"{tag}.png"), img)
    for ext in ("exr", "png"):
        assert ((tmp_path / f"jax.{ext}").read_bytes()
                == (tmp_path / f"torch.{ext}").read_bytes())
    back = torch_bitmap.read_exr(str(tmp_path / "torch.exr"))
    np.testing.assert_array_equal(
        back, jax_bitmap.read_exr(str(tmp_path / "jax.exr")))


def test_cli_refuses_unported_integrator(tmp_path, capsys):
    """Every integrator is ported; EXR viewing is the CLI surface that
    is not, and it is refused with a clear message."""
    from nori_tpu_torch.main import main

    exr = tmp_path / "img.exr"
    torch_bitmap.write_exr(str(exr), np.zeros((4, 4, 3), np.float32))
    assert main([str(exr), "-q"]) == 1
    out = capsys.readouterr().out
    assert "Fatal error" in out and "not yet ported" in out


WHITTED_XML = """<scene>
  <integrator type="whitted"/>
  <camera type="perspective">
    <transform name="toWorld">
      <lookat origin="0, 0, 3" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <float name="fov" value="40"/>
    <integer name="width" value="16"/>
    <integer name="height" value="12"/>
  </camera>
  <sampler type="independent"><integer name="sampleCount" value="2"/></sampler>
  <mesh type="obj">
    <string name="filename" value="quad.obj"/>
    <bsdf type="diffuse"/>
  </mesh>
  <mesh type="obj">
    <string name="filename" value="light.obj"/>
    <emitter type="area"><color name="radiance" value="4, 4, 4"/></emitter>
  </mesh>
</scene>
"""


def test_cli_renders_whitted(tmp_path, capsys):
    from nori_tpu_torch.main import main

    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    # a small emitter in front of the quad, facing it
    (tmp_path / "light.obj").write_text(
        "v -0.3 -0.3 1\nv 0.3 -0.3 1\nv 0.3 0.3 1\nv -0.3 0.3 1\n"
        "f 1 3 2\nf 1 4 3\n")
    xml = tmp_path / "w.xml"
    xml.write_text(WHITTED_XML)
    out_base = tmp_path / "out"
    assert main([str(xml), "-q", "-o", str(out_base), "--device", "cpu"]) == 0
    assert "Rendered 192 px x 2 spp" in capsys.readouterr().out
    img = torch_bitmap.read_exr(str(out_base) + ".exr")
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert (tmp_path / "out.png").stat().st_size > 0


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import nori_tpu_torch, nori_tpu_torch.main, nori_tpu_torch.render\n"
        "import nori_tpu_torch.wavefront, nori_tpu_torch.accel.sweep\n"
        "import nori_tpu_torch.film, nori_tpu_torch.integrators.whitted\n"
        "import nori_tpu_torch.integrators.simple_integrators\n"
        "bad = [m for m in sys.modules if m in ('jax', 'nori_tpu') or "
        "m.startswith(('jax.', 'nori_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert nori_tpu_torch.__name__ == "nori_tpu_torch"
