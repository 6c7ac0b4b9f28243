"""nori_tpu_torch host layer against nori_tpu: scene compilation,
SceneData round trip, image output bytes, the CLI (a whitted scene
rendered to EXR/PNG, other inputs refused), the default device (CUDA,
never the CPU unasked, also for the path-graph entry points), and the
jax-free import; and the one torch thread every port test file takes
(tests/torch_threads.py)."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from nori_tpu import scenes_builtin as jax_scenes
from nori_tpu import bitmap as jax_bitmap

import nori_tpu_torch
from nori_tpu_torch import bitmap as torch_bitmap
from nori_tpu_torch import film as torch_film
from nori_tpu_torch import render as torch_render
from nori_tpu_torch import scenes_builtin as torch_scenes
from nori_tpu_torch import wavefront as torch_wf
from nori_tpu_torch.integrators.path import MIS
from nori_tpu_torch.scene import HOST_ONLY, SceneData, scene_data_from_numpy

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "living_room": lambda m: m.living_room(32, 32, 1, detail=3),
    "cornell_box": lambda m: m.cornell_box(32, 32, 1, sphere_subdiv=2),
}
#: the JAX SceneData field the port does not carry: the BSDF table
#: (packed in mesh_attr)
NOT_CARRIED = {"bsdf"}


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
    # the wide BVH stays in compile_arrays(): no module reads it on the
    # device yet
    assert all(k in ref and not hasattr(sd, k) for k in HOST_ONLY)
    ref = {k: a for k, a in ref.items() if k not in HOST_ONLY}
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
    """Every integrator, test root and EXR viewing is ported; what the
    CLI still refuses, with a fatal error as the reference's
    (src/main.cpp:196-211), is an input of another extension and a root
    object that is neither a scene nor a test."""
    from nori_tpu_torch.main import main

    obj = tmp_path / "mesh.obj"
    obj.write_text("v 0 0 0\n")
    assert main([str(obj), "-q"]) == 1
    out = capsys.readouterr().out
    assert "Fatal error" in out and "expected .xml or .exr" in out
    xml = tmp_path / "bsdf.xml"
    xml.write_text('<bsdf type="diffuse"/>\n')
    assert main([str(xml), "-q", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "Fatal error" in out and "cannot be executed" in out


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


def test_no_silent_cpu_fallback(tmp_path, monkeypatch):
    """Without a CUDA device, render, render_wavefront and the CLI
    raise unless asked for the CPU; asked, they render there."""
    import torch
    from nori_tpu_torch.main import main
    from nori_tpu_torch.render import render
    from nori_tpu_torch.wavefront import render_wavefront

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render(torch_scenes.cornell_box(8, 8, 1, integrator="normals",
                                        sphere_subdiv=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_wavefront(torch_scenes.cornell_box(8, 8, 1,
                                                  sphere_subdiv=1))
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    (tmp_path / "light.obj").write_text(
        "v -0.3 -0.3 1\nv 0.3 -0.3 1\nv 0.3 0.3 1\nv -0.3 0.3 1\n"
        "f 1 3 2\nf 1 4 3\n")
    xml = tmp_path / "w.xml"
    xml.write_text(WHITTED_XML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(xml), "-q", "-o", str(tmp_path / "out")])
    img, st = render(torch_scenes.cornell_box(8, 8, 1, integrator="normals",
                                              sphere_subdiv=1),
                     device="cpu")
    assert st["device"] == "cpu" and img.shape == (8, 8, 3)
    img, st = render_wavefront(torch_scenes.cornell_box(8, 8, 1,
                                                        sphere_subdiv=1),
                               device="cpu")
    assert st["device"] == "cpu" and np.isfinite(img).all()


def _film_spec(scene):
    return torch_film.FilmSpec.for_filter(*scene.camera.output_size,
                                          scene.camera.rfilter)


#: the public factories of compiled scenes, passes, steppers, splats and
#: films: name -> fn(scene, **device), whose device defaults to the
#: first CUDA device
FACTORIES = {
    "Scene.compile": lambda s, **d: s.compile(**d),
    "make_sample_pass": lambda s, **d: torch_render.make_sample_pass(
        s, _film_spec(s), 64, **d),
    "make_sample_pass_q": lambda s, **d: torch_render.make_sample_pass_q(
        s, 64, **d),
    "make_batch_pass": lambda s, **d: torch_render.make_batch_pass(
        s, 64, **d),
    "make_wavefront_stepper": lambda s, **d: torch_wf.make_wavefront_stepper(
        s, MIS, 4096, 4096, **d),
    "make_dense_splat": lambda s, **d: torch_wf.make_dense_splat(s, 64, **d),
    "new_accumulator": lambda s, **d: torch_film.new_accumulator(
        _film_spec(s), **d),
}


@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_no_silent_cpu_fallback_of_factory(factory, monkeypatch):
    """Without a CUDA device each public factory raises unless asked
    for the CPU; asked, it makes its object there."""
    import torch

    scene = torch_scenes.cornell_box(8, 8, 1, sphere_subdiv=1)
    scene.integrator.preprocess(scene)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FACTORIES[factory](scene)
    assert FACTORIES[factory](scene, device="cpu") is not None


def test_pg_needs_a_device(tmp_path, monkeypatch):
    """Without a CUDA device the path-graph entry points raise unless
    asked for the CPU; asked, `pg` traces a scene XML and writes its
    images there."""
    import torch
    from nori_tpu_torch.pathgraph import cluster, dump, grid, pg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    (tmp_path / "light.obj").write_text(
        "v -0.3 -0.3 1\nv 0.3 -0.3 1\nv 0.3 0.3 1\nv -0.3 0.3 1\n"
        "f 1 3 2\nf 1 4 3\n")
    xml = tmp_path / "w.xml"
    xml.write_text(WHITTED_XML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pg.main([str(xml), "-k", "4"])
    scene = torch_scenes.cornell_box(8, 8, 1, sphere_subdiv=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dump.trace_dump(scene, max_depth=2)
    pos = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    g = grid.UniformGrid(pos, [3, 3, 3], np.zeros(3), np.ones(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grid.knn(pos, g, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.build_clusters(pos, [3, 3, 3], np.zeros(3), np.ones(3), 4)
    assert pg.main([str(xml), "-k", "4", "-m", "knn", "--save-dump",
                    "--device", "cpu"]) == 0
    base = str(tmp_path / "w")
    full = torch_bitmap.read_exr(base + "_k-4_full.exr")
    assert full.shape == (12, 16, 3) and np.isfinite(full).all()
    assert full.mean() > 0.01
    assert os.path.getsize(base + "_vert.bin") > 0


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import nori_tpu_torch, nori_tpu_torch.main, nori_tpu_torch.render\n"
        "import nori_tpu_torch.config, nori_tpu_torch.accel.traverse\n"
        "import nori_tpu_torch.wavefront, nori_tpu_torch.accel.sweep\n"
        "import nori_tpu_torch.film, nori_tpu_torch.integrators.whitted\n"
        "import nori_tpu_torch.integrators.simple_integrators\n"
        "import nori_tpu_torch.testing, nori_tpu_torch.warptest\n"
        "import nori_tpu_torch.tui\n"
        "import nori_tpu_torch.pathgraph.io, nori_tpu_torch.pathgraph.grid\n"
        "import nori_tpu_torch.pathgraph.bsdfgraph\n"
        "import nori_tpu_torch.pathgraph.cluster\n"
        "import nori_tpu_torch.pathgraph.aggregate\n"
        "import nori_tpu_torch.pathgraph.dump, nori_tpu_torch.pathgraph.pg\n"
        "import nori_tpu_torch.pathgraph.analysis\n"
        "import nori_tpu_torch.pathgraph.merge\n"
        "import nori_tpu_torch.pathgraph.visual\n"
        "import nori_tpu_torch.export, nori_tpu_torch.export.blender\n"
        "import nori_tpu_torch.parallel, nori_tpu_torch.profiling\n"
        "import nori_tpu_torch.bench, nori_tpu_torch.device, bench_torch\n"
        "import nori_tpu_torch.scripts.rmse_gate\n"
        "import nori_tpu_torch.scripts.pathgraph_eval\n"
        "import nori_tpu_torch.scripts.pg_protocol_report\n"
        "import nori_tpu_torch.scripts.ref_gates\n"
        "import nori_tpu_torch.scripts.multicard\n"
        # the port's console scripts (pyproject.toml) resolve
        "import importlib, tomllib\n"
        "scripts = tomllib.load(open('pyproject.toml', 'rb'))"
        "['project']['scripts']\n"
        "port = {k: v for k, v in scripts.items() "
        "if v.startswith('nori_tpu_torch.')}\n"
        "assert sorted(port) == ['nori-torch-pg', 'nori-torch-pg-visual', "
        "'nori-torch-warptest', 'nori-tpu-torch'], port\n"
        "for target in port.values():\n"
        "    mod, attr = target.split(':')\n"
        "    assert callable(getattr(importlib.import_module(mod), attr))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'nori_tpu') or "
        "m.startswith(('jax.', 'nori_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert nori_tpu_torch.__name__ == "nori_tpu_torch"


def _pins_threads(node) -> bool:
    """Whether `node` sets torch's thread count or OMP_NUM_THREADS."""
    omp = "OMP_NUM_THREADS"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr == "set_num_threads":
            return True
        first = node.args[0] if node.args else None
        return (node.func.attr == "setenv"
                and isinstance(first, ast.Constant) and first.value == omp)
    return (isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Store)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == omp)


def test_every_port_test_file_takes_one_thread():
    """Every tests/test_torch_*.py imports the module-scoped one-thread
    fixture of tests/torch_threads.py, and none pins torch's threads or
    OMP_NUM_THREADS itself: the rule is defined once.  The fixture is in
    force here too."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(here, "test_torch_*.py")))
    assert os.path.abspath(__file__) in files
    missing, pinning = [], []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        name = os.path.basename(path)
        if not any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_threads"
                   and any(a.name == "one_torch_thread" and a.asname is None
                           for a in node.names)
                   for node in tree.body):
            missing.append(name)
        pinning += [f"{name}:{node.lineno}" for node in ast.walk(tree)
                    if _pins_threads(node)]
    assert not missing, ("no `from torch_threads import one_torch_thread`: "
                         f"{missing}")
    assert not pinning, f"pins threads itself: {pinning}"
    assert torch.get_num_threads() == 1
    assert os.environ.get("OMP_NUM_THREADS") == "1"
