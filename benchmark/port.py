"""The system under test: `nori_tpu_torch`, driven through its public
plugin API and its render entry points.

`build_scene` hands a `SceneDesc` to the port as a scene graph of
plugin instances (`PropertyList` / `create_instance`, meshes as
`MeshData`), as the port's own scene builders do.  `render_image`
renders one image through the entry that `render.render_to_files`
takes for the integrator: the persistent wavefront for the path family,
the batch driver for the rest.  Nothing of the port is imported when
this module is.
"""

from __future__ import annotations

import numpy as np


def _props(values: dict):
    from nori_tpu_torch.props import PropertyList

    pl = PropertyList()
    for key, v in values.items():
        if isinstance(v, int):
            pl.set_integer(key, v)
        elif isinstance(v, float):
            pl.set_float(key, v)
        else:
            pl.set_color(key, np.asarray(v, np.float64))
    return pl


def _bsdf(desc: dict):
    from nori_tpu_torch.registry import create_instance

    params = {k: v for k, v in desc.items() if k != "type"}
    return create_instance(desc["type"], _props(params))


def build_scene(desc, integrator: str, spp: int):
    """A port `Scene` for `desc`, rendering with `integrator` at `spp`."""
    from nori_tpu_torch.core.transform import Transform
    from nori_tpu_torch.mesh import Mesh
    from nori_tpu_torch.obj_loader import MeshData
    from nori_tpu_torch.props import PropertyList
    from nori_tpu_torch.registry import create_instance
    from nori_tpu_torch.scene import Scene

    scene = Scene(PropertyList())
    for m in desc.meshes:
        mesh = Mesh()
        mesh.data = MeshData(
            positions=np.asarray(m.positions, np.float32),
            normals=(None if m.normals is None
                     else np.asarray(m.normals, np.float32)),
            texcoords=None, faces=np.asarray(m.faces, np.uint32),
            name=m.name)
        mesh.add_child(_bsdf(m.bsdf))
        if m.emitter is not None:
            mesh.add_child(create_instance(
                "area", _props({"radiance": list(m.emitter)})))
        mesh.activate()
        scene.add_child(mesh)
    c = desc.camera
    cam_pl = _props({"width": c.width, "height": c.height,
                     "fov": float(c.fov), "nearClip": float(c.near),
                     "farClip": float(c.far)})
    cam_pl.set_transform("toWorld",
                         Transform.lookat(c.origin, c.target, c.up))
    cam = create_instance("perspective", cam_pl)
    f = desc.rfilter
    cam.add_child(create_instance(f["type"], _props(
        {k: float(v) for k, v in f.items() if k != "type"})))
    cam.activate()
    scene.add_child(cam)
    scene.add_child(create_instance("independent",
                                    _props({"sampleCount": int(spp)})))
    scene.add_child(create_instance(integrator, PropertyList()))
    scene.activate()
    return scene


def compile_scene(scene) -> None:
    """The port's host-side scene compile (BVH order, tiles or slabs,
    the Baldwin-Weber operand); cached on the scene, so each image's
    `prepare` only uploads it."""
    scene.compile_arrays()


def is_path_family(integrator: str) -> bool:
    from nori_tpu_torch.integrators import PATH_FAMILY

    return integrator in PATH_FAMILY


def render_image(scene, traffic: dict, seed: int, device):
    """One image as `render_to_files` would make it, less the files:
    (image (H, W, 3) float32 numpy, the driver's stats)."""
    from nori_tpu_torch.render import render
    from nori_tpu_torch.wavefront import render_wavefront

    spp = int(traffic["spp"])
    if is_path_family(traffic["integrator"]):
        return render_wavefront(scene, spp=spp, seed=seed,
                                n_lanes=int(traffic["n_lanes"]),
                                device=device)
    return render(scene, spp=spp, seed=seed, batch=traffic.get("batch"),
                  device=device)


def reset_launches() -> None:
    from nori_tpu_torch.accel.sweep import launch_counters

    for f in launch_counters().values():
        f.launches = 0


def sweep_launches() -> dict:
    """Launch counts of the port's kernel wrappers, by name."""
    from nori_tpu_torch.accel.sweep import launch_counters

    return {k: int(f.launches) for k, f in launch_counters().items()}
