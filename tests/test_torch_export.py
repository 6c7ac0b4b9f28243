"""The Blender exporter's headless core (nori_tpu_torch.export)
against nori_tpu.export: the same scene spec writes byte-equal XML and
OBJ files, and the port's parser loads them into the scene the JAX
package's parser builds (tests/test_export.py's scene)."""

import math
import os

import numpy as np
import pytest

from nori_tpu import export as jax_export
from nori_tpu import load_from_xml as jax_load
from nori_tpu.export import blender as jax_blender

from nori_tpu_torch import export as torch_export
from nori_tpu_torch import load_from_xml as torch_load
from nori_tpu_torch.export import blender as torch_blender

from torch_threads import one_torch_thread  # noqa: F401


def _spec(m):
    """tests/test_export.py's scene from export package m: a textured
    floor quad with normals and a lifted emitter quad."""
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    lift = np.eye(4)
    lift[1, 3] = 2.0
    return m.SceneExport(
        camera=m.CameraSpec(to_world=np.eye(4), fov=40.0, width=32,
                            height=24),
        integrator="path_mis", sample_count=4,
        meshes=[
            m.MeshSpec(name="floor", positions=pos, faces=faces,
                       normals=np.tile([0.0, 0.0, 1.0], (4, 1)),
                       uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float),
                       bsdf_props={"albedo": np.array([0.5, 0.25, 0.125])}),
            m.MeshSpec(name="light", positions=pos, faces=faces,
                       to_world=lift, radiance=np.array([10.0, 9.0, 8.0])),
            m.MeshSpec(name="a b/c", positions=pos, faces=faces,
                       bsdf_type="microfacet",
                       bsdf_props={"alpha": 0.3, "kd": [0.2, 0.3, 0.4]}),
        ],
    )


def test_files_byte_equal_and_parsed_alike(tmp_path):
    files = {}
    for name, m in (("jax", jax_export), ("torch", torch_export)):
        d = tmp_path / name
        d.mkdir()
        files[name] = m.write_nori_scene(_spec(m), str(d / "scene.xml"))
    rel = [[os.path.relpath(f, tmp_path / n) for f in files[n]]
           for n in ("jax", "torch")]
    assert rel[0] == rel[1] and len(rel[1]) == 4
    for a, b in zip(files["jax"], files["torch"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b

    scene = torch_load(files["torch"][0])
    ref = jax_load(files["jax"][0])
    assert len(scene.meshes) == len(ref.meshes) == 3
    assert scene.camera.output_size == (32, 24)
    assert math.isclose(scene.camera.fov, 40.0, rel_tol=1e-6)
    assert scene.sampler.sample_count == 4
    assert scene.integrator.plugin_name == "path_mis"
    floor, light, _ = scene.meshes
    np.testing.assert_allclose(
        np.asarray(floor.bsdf.table_row()["albedo"]), [0.5, 0.25, 0.125],
        rtol=1e-6)
    assert light.is_emitter()
    np.testing.assert_allclose(light.emitter.radiance, [10, 9, 8], rtol=1e-6)
    np.testing.assert_allclose(light.data.positions[:, 1].mean(), 2.0,
                               atol=1e-6)
    got, want = scene.compile_arrays(), ref.compile()
    for field in ("tri_v0", "tri_e1", "tri_e2", "tri_attr", "mesh_attr",
                  "em_attr", "em_cdf"):
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("angle", [40.0, 75.0])
def test_blender_matrices_match(angle):
    rng = np.random.RandomState(int(angle))
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    m[:3, 3] = rng.randn(3)
    a = torch_blender.camera_spec_from_matrix(m, math.radians(angle), 0.1,
                                              100.0, 64, 48)
    b = jax_blender.camera_spec_from_matrix(m, math.radians(angle), 0.1,
                                            100.0, 64, 48)
    np.testing.assert_array_equal(a.to_world, b.to_world)
    assert (a.fov, a.width, a.height, a.near_clip, a.far_clip) == (
        b.fov, b.width, b.height, b.near_clip, b.far_clip)
    np.testing.assert_array_equal(torch_blender.mesh_to_world(m),
                                  jax_blender.mesh_to_world(m))
