"""Wavefront OBJ triangle-mesh loader.

Behavioral port of the reference loader (src/obj.cpp:30-172): supports
v/vt/vn/f records, triangle and quad faces (quads split (0,1,2)+(0,2,3)),
`p/uv/n` face-vertex triples with deduplication, and the `toWorld`
transform applied at load time (positions as points, normals through the
inverse-transpose then normalized).

Output is SoA numpy, ready for device upload: the TPU pipeline never
touches per-vertex data again after scene compilation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nori_tpu_torch.registry import NoriError
from nori_tpu_torch.core.transform import Transform


@dataclass
class MeshData:
    """Indexed triangle mesh in world space (reference mesh.h:170-179)."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray | None  # (V, 3) float32 or None
    texcoords: np.ndarray | None  # (V, 2) float32 or None
    faces: np.ndarray  # (F, 3) uint32
    name: str = ""

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def surface_areas(self) -> np.ndarray:
        p0 = self.positions[self.faces[:, 0]]
        p1 = self.positions[self.faces[:, 1]]
        p2 = self.positions[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)

    def bbox(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)

    def transformed(self, to_world) -> "MeshData":
        """Apply a toWorld transform (same load-time semantics as the
        reference OBJ loader, src/obj.cpp:117-123)."""
        m = to_world.m
        pos = (self.positions.astype(np.float64) @ m[:3, :3].T
               + m[:3, 3]).astype(np.float32)
        normals = self.normals
        if normals is not None:
            ninv = to_world.inv[:3, :3].T
            nw = normals.astype(np.float64) @ ninv.T
            nw /= np.maximum(
                np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
            normals = nw.astype(np.float32)
        return MeshData(positions=pos, normals=normals,
                        texcoords=self.texcoords, faces=self.faces,
                        name=self.name)


def _parse_face_vertex(token: str):
    parts = token.split("/")
    if not 1 <= len(parts) <= 3:
        raise NoriError(f"Invalid vertex data: '{token}'")
    p = int(parts[0])
    uv = int(parts[1]) if len(parts) >= 2 and parts[1] else 0
    n = int(parts[2]) if len(parts) >= 3 and parts[2] else 0
    return (p, uv, n)


def load_obj(filename: str, to_world: Transform | None = None) -> MeshData:
    if to_world is None:
        to_world = Transform()

    # fast path: native C++ parser (nori_tpu_torch/native.py), same dedup/quad
    # semantics; transform applied here either way
    from nori_tpu_torch import native

    parsed = native.obj_load(str(filename))
    if parsed is not None:
        pos, nrm, uv, faces = parsed
        m = to_world.m
        pos = (pos.astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(
            np.float32)
        if nrm is not None:
            nrm = nrm.astype(np.float64) @ to_world.inv[:3, :3]
            nrm /= np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            nrm = nrm.astype(np.float32)
        return MeshData(
            positions=pos, normals=nrm, texcoords=uv,
            faces=faces.astype(np.uint32), name=str(filename),
        )

    positions: list = []
    texcoords: list = []
    normals: list = []
    indices: list = []
    vertex_map: dict = {}
    vertices: list = []

    with open(filename, "r") as f:
        for line_str in f:
            line = line_str.split()
            if not line:
                continue
            prefix = line[0]
            if prefix == "v":
                positions.append([float(line[1]), float(line[2]), float(line[3])])
            elif prefix == "vt":
                texcoords.append([float(line[1]), float(line[2])])
            elif prefix == "vn":
                normals.append([float(line[1]), float(line[2]), float(line[3])])
            elif prefix == "f":
                fv = [_parse_face_vertex(t) for t in line[1:] if t]
                if len(fv) == 3:
                    tri_verts = fv
                elif len(fv) == 4:
                    # quad -> (0,1,2) + (3,0,2), matching src/obj.cpp:84-90
                    tri_verts = [fv[0], fv[1], fv[2], fv[3], fv[0], fv[2]]
                else:
                    raise NoriError(
                        f"'{filename}': only tri/quad faces supported, "
                        f"got {len(fv)} vertices"
                    )
                for v in tri_verts:
                    idx = vertex_map.get(v)
                    if idx is None:
                        idx = len(vertices)
                        vertex_map[v] = idx
                        vertices.append(v)
                    indices.append(idx)

    if not vertices:
        raise NoriError(f"'{filename}': no faces found")

    positions = np.asarray(positions, dtype=np.float64)
    # apply toWorld to raw positions once (cheaper than per-dedup-vertex)
    m = to_world.m
    positions = positions @ m[:3, :3].T + m[:3, 3]

    verts = np.asarray(vertices, dtype=np.int64)  # (V, 3): p/uv/n, 1-based
    out_pos = positions[verts[:, 0] - 1].astype(np.float32)

    out_norm = None
    if normals:
        normals = np.asarray(normals, dtype=np.float64)
        nrm_m = to_world.inv[:3, :3].T
        normals = normals @ nrm_m.T
        normals /= np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20
        )
        has_n = verts[:, 2] > 0
        if has_n.all():
            out_norm = normals[verts[:, 2] - 1].astype(np.float32)

    out_uv = None
    if texcoords:
        texcoords = np.asarray(texcoords, dtype=np.float64)
        has_uv = verts[:, 1] > 0
        if has_uv.all():
            out_uv = texcoords[verts[:, 1] - 1].astype(np.float32)

    faces = np.asarray(indices, dtype=np.uint32).reshape(-1, 3)
    return MeshData(
        positions=out_pos, normals=out_norm, texcoords=out_uv,
        faces=faces, name=str(filename),
    )
