"""The reference's own compile of a scene description: the triangle soup
in BVH order, per-triangle shading attributes, the per-mesh material
table, the emissive-triangle CDF and the camera's matrices.  Each table
is worked out from the raw arrays with the arithmetic (and float32
rounding) that the renderer's semantics fix, not read from the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import bvh

#: material type codes of the reference's table
DIFFUSE, MIRROR, DIELECTRIC, MICROFACET = 0, 1, 2, 3
_TYPES = {"diffuse": DIFFUSE, "mirror": MIRROR, "dielectric": DIELECTRIC,
          "microfacet": MICROFACET}


@dataclass
class RefScene:
    v0: torch.Tensor        # (T, 3) in BVH order
    e1: torch.Tensor
    e2: torch.Tensor
    bw: torch.Tensor        # (T, 12) Baldwin-Weber rows, see _bw_rows
    geo_n: torch.Tensor     # (T, 3)
    n0: torch.Tensor        # (T, 3) per-corner shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    mesh: torch.Tensor      # (T,) int64
    # per mesh: type, albedo(3), alpha, int_ior, ext_ior, ks, Le(3)
    mat_type: torch.Tensor  # (M,) int64
    mat: torch.Tensor       # (M, 10) float32
    em_v0: torch.Tensor     # (E, 3) emissive triangles, BVH order
    em_e1: torch.Tensor
    em_e2: torch.Tensor
    em_n0: torch.Tensor
    em_n1: torch.Tensor
    em_n2: torch.Tensor
    em_le: torch.Tensor     # (E, 3)
    em_cdf: torch.Tensor    # (E + 1,) float32
    em_area: torch.Tensor   # () float32 total emissive area
    # the BVH walked by trace.py
    node_left: torch.Tensor
    node_right: torch.Tensor
    node_start: torch.Tensor
    node_count: torch.Tensor
    node_bmin: torch.Tensor
    node_bmax: torch.Tensor
    # camera
    sample_to_camera: torch.Tensor  # (4, 4) float32
    camera_to_world: torch.Tensor   # (4, 4) float32
    width: int
    height: int
    near: float
    far: float
    rfilter: dict


def _material_row(desc: dict, emitter) -> tuple[int, list]:
    kind = _TYPES[desc["type"]]
    albedo = [0.0, 0.0, 0.0]
    alpha, int_ior, ext_ior, ks = 0.0, 1.0, 1.0, 0.0
    if kind == DIFFUSE:
        albedo = desc.get("albedo", [0.5, 0.5, 0.5])
    elif kind == MIRROR:
        albedo = [1.0, 1.0, 1.0]
    elif kind == DIELECTRIC:
        albedo = [1.0, 1.0, 1.0]
        int_ior = desc.get("intIOR", 1.5046)
        ext_ior = desc.get("extIOR", 1.000277)
    else:
        albedo = desc.get("kd", [0.5, 0.5, 0.5])
        alpha = desc.get("alpha", 0.1)
        int_ior = desc.get("intIOR", 1.5046)
        ext_ior = desc.get("extIOR", 1.000277)
        # energy split of the rough plastic: ks = 1 - max(kd)
        ks = 1.0 - float(np.max(np.asarray(albedo, np.float64)))
    le = list(emitter) if emitter is not None else [0.0, 0.0, 0.0]
    return kind, [*albedo, alpha, int_ior, ext_ior, ks, *le]


def _bw_rows(v0, e1, e2) -> np.ndarray:
    """(T, 12) rows [n(3) | d_plane | U(3) | u_w | V(3) | v_w] of the
    Baldwin-Weber test ("Fast Ray-Triangle Intersections by Coordinate
    Transformation", JCGT 2016): t = -(n.o + d_plane) / (n.d) and the
    barycentrics u = U.p + u_w, v = V.p + v_w of the hit point, with
    n = e1 x e2, so that |n.d| > 1e-8 is Moller-Trumbore's |det|
    cutoff.  Computed in float64 and rounded once to float32, the
    rounding the renderer states for its triangle test."""
    v0d, e1d, e2d = (a.astype(np.float64) for a in (v0, e1, e2))
    n = np.cross(e1d, e2d)
    nn = np.einsum("ij,ij->i", n, n)
    safe = np.where(nn > 0.0, nn, 1.0)[:, None]
    U = np.cross(e2d, n) / safe
    V = np.cross(n, e1d) / safe
    rows = np.concatenate([
        n, -np.einsum("ij,ij->i", n, v0d)[:, None],
        U, -np.einsum("ij,ij->i", U, v0d)[:, None],
        V, -np.einsum("ij,ij->i", V, v0d)[:, None]], axis=1)
    return rows.astype(np.float32)


def _lookat(origin, target, up) -> np.ndarray:
    origin, target, up = (np.asarray(x, np.float64)
                          for x in (origin, target, up))
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    new_up = new_up / np.linalg.norm(new_up)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, new_up, d, origin
    return m


def _sample_to_camera(width, height, fov, near, far) -> np.ndarray:
    """Inverse of scale * translate * perspective (src/perspective.cpp:
    60-80), each factor inverted on its own as Nori's Transform does."""
    aspect = width / float(height)
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov) / 2.0)
    persp = np.array([[cot, 0, 0, 0], [0, cot, 0, 0],
                      [0, 0, far * recip, -near * far * recip],
                      [0, 0, 1, 0]], np.float64)
    scale = np.eye(4)
    scale[0, 0], scale[1, 1], scale[2, 2] = -0.5, -0.5 * aspect, 1.0
    translate = np.eye(4)
    translate[:3, 3] = [-1.0, -1.0 / aspect, 0.0]
    inv = np.linalg.inv
    return inv(persp) @ (inv(translate) @ inv(scale))


def compile_scene(desc, device) -> RefScene:
    """RefScene of `desc` on `device`."""
    v0l, e1l, e2l, n0l, n1l, n2l, ids, areas = ([] for _ in range(8))
    kinds, rows = [], []
    for mi, m in enumerate(desc.meshes):
        pos = np.asarray(m.positions, np.float32)
        f = np.asarray(m.faces, np.int64)
        p0, p1, p2 = (pos[f[:, k]].astype(np.float64) for k in range(3))
        v0l.append(p0)
        e1l.append(p1 - p0)
        e2l.append(p2 - p0)
        if m.normals is not None:
            nrm = np.asarray(m.normals, np.float32)
            n0l.append(nrm[f[:, 0]])
            n1l.append(nrm[f[:, 1]])
            n2l.append(nrm[f[:, 2]])
        else:
            gn = np.cross(p1 - p0, p2 - p0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-20)
            n0l.append(gn), n1l.append(gn), n2l.append(gn)
        ids.append(np.full(f.shape[0], mi, np.int64))
        q0, q1, q2 = (pos[f[:, k]] for k in range(3))
        areas.append(0.5 * np.linalg.norm(np.cross(q1 - q0, q2 - q0),
                                          axis=-1))
        kind, row = _material_row(m.bsdf, m.emitter)
        kinds.append(kind)
        rows.append(row)
    v0 = np.concatenate(v0l).astype(np.float32)
    e1 = np.concatenate(e1l).astype(np.float32)
    e2 = np.concatenate(e2l).astype(np.float32)
    n0 = np.concatenate(n0l).astype(np.float32)
    n1 = np.concatenate(n1l).astype(np.float32)
    n2 = np.concatenate(n2l).astype(np.float32)
    mesh = np.concatenate(ids)
    area = np.concatenate(areas)
    tree = bvh.build(v0, e1, e2)
    o = tree.order
    v0, e1, e2, n0, n1, n2 = (a[o] for a in (v0, e1, e2, n0, n1, n2))
    mesh, area = mesh[o], area[o]
    geo_n = np.cross(e1, e2)
    geo_n = geo_n / np.maximum(np.linalg.norm(geo_n, axis=-1,
                                              keepdims=True), 1e-24)
    mat = np.asarray(rows, np.float32)
    emissive = np.asarray([m.emitter is not None for m in desc.meshes])
    em = np.nonzero(emissive[mesh])[0]
    if em.size == 0:
        raise ValueError("the reference needs at least one area light")
    cdf = np.concatenate([[0.0], np.cumsum(area[em])])
    total = cdf[-1]
    cdf = (cdf / total).astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    c = desc.camera
    return RefScene(
        v0=t(v0), e1=t(e1), e2=t(e2), bw=t(_bw_rows(v0, e1, e2)),
        geo_n=t(geo_n.astype(np.float32)),
        n0=t(n0), n1=t(n1), n2=t(n2), mesh=t(mesh),
        mat_type=t(np.asarray(kinds, np.int64)), mat=t(mat),
        em_v0=t(v0[em]), em_e1=t(e1[em]), em_e2=t(e2[em]),
        em_n0=t(n0[em]), em_n1=t(n1[em]), em_n2=t(n2[em]),
        em_le=t(mat[mesh[em], 7:10]), em_cdf=t(cdf),
        em_area=t(np.float32(total)),
        node_left=t(tree.left), node_right=t(tree.right),
        node_start=t(tree.start), node_count=t(tree.count),
        node_bmin=t(tree.bmin), node_bmax=t(tree.bmax),
        sample_to_camera=t(_sample_to_camera(
            c.width, c.height, c.fov, c.near, c.far), torch.float32),
        camera_to_world=t(_lookat(c.origin, c.target, c.up), torch.float32),
        width=int(c.width), height=int(c.height), near=float(c.near),
        far=float(c.far), rfilter=dict(desc.rfilter),
    )
