"""Blender -> Nori scene exporter.

Copy of `nori_tpu/export/blender.py` (numpy and string formatting);
it writes the same bytes, down to the OBJ header comment.

Counterpart of the reference add-on (upstream ext/plugin/
io_nori.py:13-193): exports a scene to Nori XML plus one OBJ file per
mesh under meshes/.  Split in two layers so the exporter is testable
without Blender:

* a HEADLESS CORE (`SceneExport` + `write_nori_scene`) operating on
  plain numpy data: camera spec, mesh specs (vertices/faces/normals/
  uvs, a 4x4 world matrix, optional BSDF + emitter), writing XML our
  parser round-trips (tests/test_export.py);
* a thin bpy ADD-ON layer (`register`/`unregister`/`NoriExporter`)
  that extracts those specs from Blender objects, converting Z-up to
  Y-up and applying the camera axis flip the reference applies, plus
  a material conversion the reference leaves as a TODO: Principled
  BSDF base color -> diffuse albedo, emission -> area emitter.

The OBJ writer is self-contained (the reference shells out to
bpy.ops.export_scene.obj, which no longer exists in Blender >= 4.0).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional
from xml.sax.saxutils import quoteattr

import numpy as np


# ---------------------------------------------------------------------------
# headless core
# ---------------------------------------------------------------------------

@dataclass
class CameraSpec:
    to_world: np.ndarray          # (4, 4) Nori-convention camera matrix
    fov: float = 30.0             # x-fov, degrees
    width: int = 768
    height: int = 768
    near_clip: float = 1e-4
    far_clip: float = 1e4


@dataclass
class MeshSpec:
    name: str
    positions: np.ndarray                    # (V, 3) float, object space
    faces: np.ndarray                        # (F, 3) int (triangles)
    normals: Optional[np.ndarray] = None     # (V, 3)
    uvs: Optional[np.ndarray] = None         # (V, 2)
    to_world: Optional[np.ndarray] = None    # (4, 4); None = identity
    bsdf_type: str = "diffuse"
    bsdf_props: dict = field(default_factory=dict)  # name -> value
    radiance: Optional[np.ndarray] = None    # (3,) -> area emitter


@dataclass
class SceneExport:
    camera: Optional[CameraSpec] = None
    meshes: list = field(default_factory=list)
    integrator: str = "path_mis"
    sample_count: int = 32


def _fmt(x) -> str:
    if isinstance(x, (np.ndarray, list, tuple)):
        return ",".join(_fmt(v) for v in np.asarray(x).ravel())
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    return str(x)


def _prop_tag(value) -> str:
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, np.integer)):
        return "integer"
    if isinstance(value, (float, np.floating)):
        return "float"
    if isinstance(value, (np.ndarray, list, tuple)):
        return "color"
    return "string"


class _Xml:
    """Tiny indenting XML writer (keeps the exporter dependency-free)."""

    def __init__(self):
        self.lines = ['<?xml version="1.0" encoding="utf-8"?>']
        self.depth = 0

    def open(self, tag, **attrs):
        self.lines.append(self._fmt_tag(tag, attrs, close=False))
        self.depth += 1

    def leaf(self, tag, **attrs):
        self.lines.append(self._fmt_tag(tag, attrs, close=True))

    def close(self, tag):
        self.depth -= 1
        self.lines.append("\t" * self.depth + f"</{tag}>")

    def _fmt_tag(self, tag, attrs, close):
        a = "".join(
            f" {k}={quoteattr(str(v))}" for k, v in attrs.items())
        end = "/>" if close else ">"
        return "\t" * self.depth + f"<{tag}{a}{end}"

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def write_obj(path: str, mesh: MeshSpec) -> None:
    """Write a minimal v/vn/vt/f OBJ our loader (and the reference's,
    src/obj.cpp:30-172) reads back; faces are 1-indexed triangles."""
    pos = np.asarray(mesh.positions, np.float64)
    faces = np.asarray(mesh.faces, np.int64) + 1
    has_n = mesh.normals is not None
    has_t = mesh.uvs is not None
    with open(path, "w") as f:
        f.write(f"# exported by nori_tpu ({mesh.name})\n")
        for p in pos:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        if has_t:
            for t in np.asarray(mesh.uvs, np.float64):
                f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if has_n:
            for n in np.asarray(mesh.normals, np.float64):
                f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        for a, b, c in faces:
            if has_n and has_t:
                f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
            elif has_n:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            elif has_t:
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def write_nori_scene(export: SceneExport, xml_path: str) -> list:
    """Write scene.xml + meshes/*.obj; returns the written file list."""
    out_dir = os.path.dirname(os.path.abspath(xml_path))
    mesh_dir = os.path.join(out_dir, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    written = []

    x = _Xml()
    x.open("scene")
    x.leaf("integrator", type=export.integrator)
    x.open("sampler", type="independent")
    x.leaf("integer", name="sampleCount", value=str(export.sample_count))
    x.close("sampler")

    if export.camera is not None:
        cam = export.camera
        x.open("camera", type="perspective")
        x.leaf("float", name="fov", value=_fmt(cam.fov))
        x.leaf("float", name="nearClip", value=_fmt(cam.near_clip))
        x.leaf("float", name="farClip", value=_fmt(cam.far_clip))
        x.leaf("integer", name="width", value=str(cam.width))
        x.leaf("integer", name="height", value=str(cam.height))
        x.open("transform", name="toWorld")
        x.leaf("matrix", value=_fmt(np.asarray(cam.to_world)))
        x.close("transform")
        x.close("camera")

    used = set()
    for mesh in export.meshes:
        base = "".join(
            c if (c.isalnum() or c in "-_.") else "_" for c in mesh.name
        ) or "mesh"
        name = base
        k = 1
        while name in used:
            name = f"{base}_{k}"
            k += 1
        used.add(name)
        obj_rel = f"meshes/{name}.obj"
        obj_path = os.path.join(out_dir, obj_rel)
        write_obj(obj_path, mesh)
        written.append(obj_path)

        x.open("mesh", type="obj")
        x.leaf("string", name="filename", value=obj_rel)
        if mesh.to_world is not None:
            m = np.asarray(mesh.to_world)
            if not np.allclose(m, np.eye(4)):
                x.open("transform", name="toWorld")
                x.leaf("matrix", value=_fmt(m))
                x.close("transform")
        x.open("bsdf", type=mesh.bsdf_type)
        for pname, pval in mesh.bsdf_props.items():
            x.leaf(_prop_tag(pval), name=pname, value=_fmt(pval))
        x.close("bsdf")
        if mesh.radiance is not None:
            x.open("emitter", type="area")
            x.leaf("color", name="radiance", value=_fmt(mesh.radiance))
            x.close("emitter")
        x.close("mesh")

    x.close("scene")
    with open(xml_path, "w") as f:
        f.write(x.text())
    written.insert(0, xml_path)
    return written


# ---------------------------------------------------------------------------
# Blender add-on layer (requires bpy; inert elsewhere)
# ---------------------------------------------------------------------------

bl_info = {
    "name": "Export Nori scene format (nori_tpu)",
    "version": (0, 2),
    "blender": (2, 80, 0),
    "location": "File > Export > Nori scene (.xml)",
    "description": "Export scene to Nori XML + OBJ meshes",
    "category": "Import-Export",
}

#: Blender Z-up to Nori Y-up change of basis
_BLENDER_TO_NORI = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 1.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]]
)
#: Blender cameras look down -Z with +Y up; Nori cameras look down +Z
#: with +Y up in camera space, so X and Z flip (matches the reference
#: exporter's flip, io_nori.py:118-124)
_CAM_FLIP = np.diag([-1.0, 1.0, -1.0, 1.0])


def camera_spec_from_matrix(matrix_world, angle_x, clip_start, clip_end,
                            width, height) -> CameraSpec:
    """Blender camera parameters -> Nori CameraSpec (pure math, unit
    tested without bpy)."""
    m = _BLENDER_TO_NORI @ np.asarray(matrix_world, np.float64)
    m = m @ _CAM_FLIP
    import math

    return CameraSpec(
        to_world=m,
        fov=math.degrees(float(angle_x)),
        width=int(width), height=int(height),
        near_clip=float(clip_start), far_clip=float(clip_end),
    )


def mesh_to_world(matrix_world) -> np.ndarray:
    return _BLENDER_TO_NORI @ np.asarray(matrix_world, np.float64)


def _bpy_material(obj):
    """Principled base color -> diffuse albedo; emission -> radiance."""
    bsdf_type, props, radiance = "diffuse", {"albedo": np.full(3, 0.75)}, None
    try:
        mat = obj.active_material
        node = None
        if mat and mat.use_nodes:
            for n in mat.node_tree.nodes:
                if n.type == "BSDF_PRINCIPLED":
                    node = n
                    break
        if node is not None:
            base = np.asarray(node.inputs["Base Color"].default_value[:3])
            props = {"albedo": base}
            estr = node.inputs.get("Emission Strength")
            ecol = node.inputs.get("Emission Color") \
                or node.inputs.get("Emission")
            if estr is not None and ecol is not None \
                    and estr.default_value > 0:
                rad = np.asarray(ecol.default_value[:3]) * estr.default_value
                if rad.max() > 0:
                    radiance = rad
        elif mat is not None:
            props = {"albedo": np.asarray(mat.diffuse_color[:3])}
    except Exception:
        pass
    return bsdf_type, props, radiance


def export_from_bpy(context, filepath: str,
                    integrator="path_mis", sample_count=32) -> list:
    import bpy  # noqa: F401

    scene = context.scene
    export = SceneExport(integrator=integrator, sample_count=sample_count)

    cams = [o for o in scene.objects if o.type == "CAMERA"]
    if cams:
        cam = cams[0]
        pct = scene.render.resolution_percentage / 100.0
        export.camera = camera_spec_from_matrix(
            [list(r) for r in cam.matrix_world],
            cam.data.angle_x, cam.data.clip_start, cam.data.clip_end,
            int(scene.render.resolution_x * pct),
            int(scene.render.resolution_y * pct),
        )

    deps = context.evaluated_depsgraph_get()
    for obj in scene.objects:
        if obj.type != "MESH":
            continue
        ev = obj.evaluated_get(deps)
        me = ev.to_mesh()
        me.calc_loop_triangles()
        v = np.empty(3 * len(me.vertices))
        me.vertices.foreach_get("co", v)
        faces = np.array(
            [list(t.vertices) for t in me.loop_triangles], np.int64
        ).reshape(-1, 3)
        nrm = np.empty(3 * len(me.vertices))
        me.vertices.foreach_get("normal", nrm)
        bsdf_type, props, radiance = _bpy_material(obj)
        export.meshes.append(MeshSpec(
            name=obj.name,
            positions=v.reshape(-1, 3),
            faces=faces,
            normals=nrm.reshape(-1, 3),
            to_world=mesh_to_world([list(r) for r in obj.matrix_world]),
            bsdf_type=bsdf_type, bsdf_props=props, radiance=radiance,
        ))
        ev.to_mesh_clear()
    return write_nori_scene(export, filepath)


try:  # pragma: no cover - requires Blender
    import bpy
    from bpy_extras.io_utils import ExportHelper

    class NoriExporter(bpy.types.Operator, ExportHelper):
        """Export the current scene to Nori XML."""

        bl_idname = "export.nori_tpu"
        bl_label = "Export Nori scene"
        filename_ext = ".xml"

        def execute(self, context):
            export_from_bpy(context, self.filepath)
            return {"FINISHED"}

    def _menu(self, context):
        self.layout.operator(NoriExporter.bl_idname,
                             text="Nori scene (.xml)")

    def register():
        bpy.utils.register_class(NoriExporter)
        bpy.types.TOPBAR_MT_file_export.append(_menu)

    def unregister():
        bpy.utils.unregister_class(NoriExporter)
        bpy.types.TOPBAR_MT_file_export.remove(_menu)

except ImportError:  # headless: core API only
    pass
