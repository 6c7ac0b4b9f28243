"""Plain scene descriptions and the geometry the configurations build
them from.

A configuration (`benchmark/configs/<name>.py`) turns its JSON file into
a `SceneDesc`: raw vertex and face arrays per mesh, each mesh's material
and emitter, the camera and the reconstruction filter.  The same
description goes to the program (through its plugin API, `port.py`) and
to the plain reference (as arrays, `reference/`), so neither side reads
what the other derived.

The helpers are frozen numpy copies of the port's procedural generators
(`nori_tpu_torch/scenes_builtin.py`), kept here so that a change to the
program cannot change the scenes the benchmark renders.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MeshDesc:
    name: str
    positions: np.ndarray          # (V, 3) float32, world space
    faces: np.ndarray              # (F, 3) uint32
    bsdf: dict                     # {"type": ..., parameters}
    normals: np.ndarray | None = None   # (V, 3) float32 per-vertex
    emitter: list | None = None    # area-light radiance (rgb) or None


@dataclass
class CameraDesc:
    width: int
    height: int
    fov: float
    origin: list
    target: list
    up: list
    near: float = 1e-4
    far: float = 1e4


@dataclass
class SceneDesc:
    meshes: list
    camera: CameraDesc
    #: Nori's default reconstruction filter (src/rfilter.cpp)
    rfilter: dict = field(default_factory=lambda: {
        "type": "gaussian", "radius": 2.0, "stddev": 0.5})


def quad(p0, p1, p2, p3):
    """Two triangles (p0, p1, p2) + (p0, p2, p3)."""
    verts = np.asarray([p0, p1, p2, p3], dtype=np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], dtype=np.uint32)
    return verts, faces


def icosphere(center, radius, subdiv=2):
    """Subdivided icosahedron: (positions, faces, per-vertex normals)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdiv):
        mid = {}
        new_faces = []
        verts = list(map(tuple, verts))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                v = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                v /= np.linalg.norm(v)
                mid[key] = len(verts)
                verts.append(tuple(v))
            return mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces, dtype=np.int64)
        verts = np.asarray(verts, dtype=np.float64)
    verts = np.asarray(verts, dtype=np.float64)
    pos = (verts * radius + np.asarray(center)).astype(np.float32)
    return pos, faces.astype(np.uint32), verts.astype(np.float32)


def box(center, half, rot_y=0.0):
    """12-triangle box with outward windings, optionally turned about y."""
    hx, hy, hz = half
    corners = np.array([
        [sx * hx, sy * hy, sz * hz]
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
    ], dtype=np.float32)
    if rot_y:
        c, s = np.cos(rot_y), np.sin(rot_y)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        corners = corners @ rot.T
    corners += np.asarray(center, np.float32)
    quads = [(0, 1, 3, 2), (6, 7, 5, 4), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c2, d in quads:
        faces += [[a, b, c2], [a, c2, d]]
    return corners, np.asarray(faces, np.uint32)


def diffuse(albedo):
    return {"type": "diffuse", "albedo": [float(a) for a in albedo]}


def microfacet(alpha, kd, int_ior=1.5046, ext_ior=1.000277):
    """Beckmann rough plastic; Nori's default IORs (src/microfacet.cpp)."""
    return {"type": "microfacet", "alpha": float(alpha),
            "kd": [float(k) for k in kd], "intIOR": float(int_ior),
            "extIOR": float(ext_ior)}


def dielectric(int_ior=1.5046, ext_ior=1.000277):
    return {"type": "dielectric", "intIOR": float(int_ior),
            "extIOR": float(ext_ior)}


MIRROR = {"type": "mirror"}
BLACK = {"type": "diffuse", "albedo": [0.0, 0.0, 0.0]}
