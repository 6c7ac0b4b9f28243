"""Scene: host object graph + compilation to tensors.

Port of `nori_tpu/scene.py`.  The host side mirrors the reference Scene
(include/nori/scene.h:32-125, src/scene.cpp): it owns meshes, the
camera, one integrator and one sampler, wires children by class kind,
and finalizes on activate().  Scene-level children of kind emitter are
rejected (only mesh-attached area lights are supported).

`Scene.compile_arrays()` flattens the scene into numpy arrays with the
same build as the JAX package (so the arrays are equal bit for bit);
`Scene.compile(device)` wraps them as a `SceneData` of tensors on the
device.  `scene_data_from_numpy` turns the JAX package's compiled
SceneData, read out as numpy arrays, into the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.registry import register_class, NoriError, create_instance
from nori_tpu_torch.bsdf import table_arrays
# triangles per tile of the resident sweep / per slab of the streamed one
from nori_tpu_torch.accel.sweep import FINE_T, STREAM_T

TRI_PAD = 512  # triangle padding granularity (the JAX package's)
#: the JAX package sizes tile bounds by a TPU memory budget: soups with
#: 9*T*4 bytes above it are "streamed" and get STREAM_T-triangle tiles
#: and 16-row operands.  The same rule is kept here so the compiled
#: arrays stay equal; accel.traverse sends 16-row operands to the
#: streamed sweep (kernel K5).
STREAMED_BYTES = 8 * 1024 * 1024


def _build_tri_bw(v0, e1, e2, n_tris):
    """(12, T) Baldwin-Weber transform rows for the resident sweep:
    [n(3) | d_plane | U(3) | u_w | V(3) | v_w] per triangle, so the
    kernel evaluates t = -(n.o + d_plane)/(n.d) and barycentrics as
    affine functions u = U.p + u_w, v = V.p + v_w of the hit point
    p = o + t d ("Fast Ray-Triangle Intersections by Coordinate
    Transformation", Baldwin & Weber, JCGT 2016).  With n = e1 x e2
    the kernel's |n.d| > 1e-8 cutoff equals Moller-Trumbore's |det|
    cutoff (src/mesh.cpp:56-59): det = e1.(d x e2) = -(n.d).  Rows
    are computed in float64 and rounded once.  Padded/degenerate
    triangles get n = 0 -> den = 0 -> never hit.
    """
    v0d = v0.astype(np.float64)
    n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    nn = np.einsum("ij,ij->i", n, n)
    safe = np.where(nn > 0.0, nn, 1.0)[:, None]
    U = np.cross(e2.astype(np.float64), n) / safe
    V = np.cross(n, e1.astype(np.float64)) / safe
    out = np.zeros((12, v0.shape[0]), np.float32)
    out[0:3] = n.T
    out[3] = -np.einsum("ij,ij->i", n, v0d)
    out[4:7] = U.T
    out[7] = -np.einsum("ij,ij->i", U, v0d)
    out[8:11] = V.T
    out[11] = -np.einsum("ij,ij->i", V, v0d)
    out[:, n_tris:] = 0.0
    return out




@dataclasses.dataclass
class SceneData:
    """Flat render-ready scene: tensors on one device.

    Field for field the JAX package's SceneData, less `tri_mxu` (the
    MXU operand, which nothing in the port reads) and `bsdf` (the
    per-mesh BSDF table, which `mesh_attr` carries packed).
    """

    # triangle soup, world space; padded rows are degenerate & far away
    tri_v0: torch.Tensor   # (T, 3)
    tri_e1: torch.Tensor   # (T, 3)  p1 - p0
    tri_e2: torch.Tensor   # (T, 3)  p2 - p0
    tri_n0: torch.Tensor   # (T, 3)  per-corner shading normals
    tri_n1: torch.Tensor   # (T, 3)
    tri_n2: torch.Tensor   # (T, 3)
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor  # (T, 2)
    tri_uv2: torch.Tensor  # (T, 2)
    tri_mesh: torch.Tensor  # (T,) int32 mesh id
    # [geo_n(3), n0(3), n1(3), n2(3), uv0(2), uv1(2), uv2(2),
    #  mesh-id-bits(1), v0(3), e1(3), e2(3)]: one gather per hit
    tri_attr: torch.Tensor  # (T, 28)
    # [v0(3), e1(3), e2(3), n0(3), n1(3), n2(3), radiance(3), pad(3)]
    em_attr: torch.Tensor   # (E, 24)
    # [type-bits(1), albedo(3), alpha, int_ior, ext_ior, ks, Le(3), pad]
    mesh_attr: torch.Tensor  # (M, 12)
    tri_packed: torch.Tensor  # (9, T) [v0|e1|e2] Moller-Trumbore operand
    tri_bw: torch.Tensor    # (12, T) Baldwin-Weber operand
    tri_tile_bounds: torch.Tensor  # (T/FINE_T, 8) per-tile AABBs
    scene_bounds: torch.Tensor  # (1, 8) [center xyz, half-diag, ...]
    em_radiance: torch.Tensor   # (M, 3)
    mesh_emissive: torch.Tensor  # (M,) bool
    em_tri: torch.Tensor        # (E,) int32 triangle ids
    em_cdf: torch.Tensor        # (E+1,) float32
    em_area: torch.Tensor       # () total emissive area
    n_emissive: torch.Tensor    # () int32
    bbox_min: torch.Tensor      # (3,)
    bbox_max: torch.Tensor      # (3,)
    # wide BVH (built for the triangle order; no traversal is ported)
    bvh_child: torch.Tensor     # (NODES, W) int32
    bvh_count: torch.Tensor     # (NODES, W) int32
    bvh_bmin: torch.Tensor      # (NODES, W, 3)
    bvh_bmax: torch.Tensor      # (NODES, W, 3)

    def to(self, device) -> "SceneData":
        return SceneData(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def scene_data_from_numpy(arrays: dict, device) -> SceneData:
    """SceneData on `device` from numpy arrays keyed by field name.

    Keys the port does not carry (`tri_mxu`, `bsdf`) are ignored, so
    the dict read out of the JAX package's SceneData can be passed
    as it is."""
    return SceneData(**{
        f.name: torch.tensor(np.array(arrays[f.name], order="C"), device=device)
        for f in dataclasses.fields(SceneData)})


@register_class("scene")
class Scene(NoriObject):
    class_kind = registry.SCENE

    def __init__(self, props: PropertyList):
        self.meshes = []
        self.camera = None
        self.integrator = None
        self.sampler = None

    def activate(self):
        if self.integrator is None:
            raise NoriError("No integrator was specified!")
        if self.camera is None:
            raise NoriError("No camera was specified!")
        if self.sampler is None:
            # default: independent sampler, one sample (src/scene.cpp:43-51)
            self.sampler = create_instance("independent", PropertyList())
        self._data = None

    def add_child(self, child):
        kind = child.class_kind
        if kind == registry.MESH:
            self.meshes.append(child)
        elif kind == registry.EMITTER:
            raise NoriError(
                "Scene: only mesh-attached area emitters are supported"
            )
        elif kind == registry.SAMPLER:
            if self.sampler is not None:
                raise NoriError("Scene: multiple samplers!")
            self.sampler = child
        elif kind == registry.CAMERA:
            if self.camera is not None:
                raise NoriError("Scene: multiple cameras!")
            self.camera = child
        elif kind == registry.INTEGRATOR:
            if self.integrator is not None:
                raise NoriError("Scene: multiple integrators!")
            self.integrator = child
        else:
            super().add_child(child)

    # -- compilation --------------------------------------------------------
    def compile(self, device="cpu") -> SceneData:
        """The compiled scene as tensors on `device`."""
        return scene_data_from_numpy(self.compile_arrays(), device)

    def compile_arrays(self) -> dict:
        """Flatten the object graph into numpy arrays (cached)."""
        if getattr(self, "_data", None) is not None:
            return self._data
        if not self.meshes:
            raise NoriError("Scene contains no meshes")

        v0l, e1l, e2l = [], [], []
        n0l, n1l, n2l = [], [], []
        uv0l, uv1l, uv2l = [], [], []
        mesh_ids = []
        areas_all = []

        for mi, mesh in enumerate(self.meshes):
            md = mesh.data
            p0 = md.positions[md.faces[:, 0]].astype(np.float64)
            p1 = md.positions[md.faces[:, 1]].astype(np.float64)
            p2 = md.positions[md.faces[:, 2]].astype(np.float64)
            v0l.append(p0)
            e1l.append(p1 - p0)
            e2l.append(p2 - p0)
            gn = np.cross(p1 - p0, p2 - p0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            if md.normals is not None:
                n0l.append(md.normals[md.faces[:, 0]])
                n1l.append(md.normals[md.faces[:, 1]])
                n2l.append(md.normals[md.faces[:, 2]])
            else:
                n0l.append(gn)
                n1l.append(gn)
                n2l.append(gn)
            if md.texcoords is not None:
                uv0l.append(md.texcoords[md.faces[:, 0]])
                uv1l.append(md.texcoords[md.faces[:, 1]])
                uv2l.append(md.texcoords[md.faces[:, 2]])
            else:
                z = np.zeros((md.num_faces, 2), dtype=np.float32)
                uv0l.append(z)
                uv1l.append(z)
                uv2l.append(z)
            mesh_ids.append(np.full(md.num_faces, mi, dtype=np.int32))
            areas_all.append(md.surface_areas())

        v0 = np.concatenate(v0l).astype(np.float32)
        e1 = np.concatenate(e1l).astype(np.float32)
        e2 = np.concatenate(e2l).astype(np.float32)
        n0 = np.concatenate(n0l).astype(np.float32)
        n1 = np.concatenate(n1l).astype(np.float32)
        n2 = np.concatenate(n2l).astype(np.float32)
        uv0 = np.concatenate(uv0l).astype(np.float32)
        uv1 = np.concatenate(uv1l).astype(np.float32)
        uv2 = np.concatenate(uv2l).astype(np.float32)
        tri_mesh = np.concatenate(mesh_ids)
        areas = np.concatenate(areas_all)
        n_tris = v0.shape[0]
        self.n_triangles = n_tris

        bbox_min = v0.min(axis=0)
        bbox_max = (v0 + np.maximum(e1, 0) + np.maximum(e2, 0)).max(axis=0)
        p1 = v0 + e1
        p2 = v0 + e2
        bbox_min = np.minimum(np.minimum(v0.min(0), p1.min(0)), p2.min(0))
        bbox_max = np.maximum(np.maximum(v0.max(0), p1.max(0)), p2.max(0))

        # --- build the BVH over the unpadded soup, then reorder ------------
        from nori_tpu_torch.accel.bvh import build_bvh
        order, bvh = build_bvh(v0, e1, e2)
        perm = np.asarray(order)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        n0, n1, n2 = n0[perm], n1[perm], n2[perm]
        uv0, uv1, uv2 = uv0[perm], uv1[perm], uv2[perm]
        tri_mesh = tri_mesh[perm]
        areas = areas[perm]
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n_tris)

        # --- pad triangles to a tile-friendly count -------------------------
        pad = (-n_tris) % TRI_PAD
        if pad:
            far = np.full((pad, 3), 1e30, dtype=np.float32)
            zero3 = np.zeros((pad, 3), dtype=np.float32)
            zero2 = np.zeros((pad, 2), dtype=np.float32)
            v0 = np.concatenate([v0, far])
            e1 = np.concatenate([e1, zero3])
            e2 = np.concatenate([e2, zero3])
            n0 = np.concatenate([n0, zero3])
            n1 = np.concatenate([n1, zero3])
            n2 = np.concatenate([n2, zero3])
            uv0 = np.concatenate([uv0, zero2])
            uv1 = np.concatenate([uv1, zero2])
            uv2 = np.concatenate([uv2, zero2])
            tri_mesh = np.concatenate(
                [tri_mesh, np.zeros(pad, dtype=np.int32)]
            )

        # --- per-tile AABBs for sweep culling ------------------------------
        t_padded = v0.shape[0]
        streamed = 9 * t_padded * 4 > STREAMED_BYTES
        tile_gran = STREAM_T if streamed else FINE_T
        n_tiles = t_padded // tile_gran
        tile_bounds = np.zeros((n_tiles, 8), dtype=np.float32)
        p1f = v0 + e1
        p2f = v0 + e2
        valid = (np.arange(t_padded) < n_tris)[:, None]
        lo3 = np.minimum(np.minimum(
            np.where(valid, v0, np.inf), np.where(valid, p1f, np.inf)),
            np.where(valid, p2f, np.inf))
        hi3 = np.maximum(np.maximum(
            np.where(valid, v0, -np.inf), np.where(valid, p1f, -np.inf)),
            np.where(valid, p2f, -np.inf))
        tile_bounds[:, 0:3] = lo3.reshape(n_tiles, tile_gran, 3).min(1)
        tile_bounds[:, 3:6] = hi3.reshape(n_tiles, tile_gran, 3).max(1)
        center = 0.5 * (bbox_min + bbox_max)
        half_diag = 0.5 * float(np.linalg.norm(bbox_max - bbox_min)) + 1e-3
        scene_bounds_row = np.zeros((1, 8), dtype=np.float32)
        scene_bounds_row[0, 0:3] = center
        scene_bounds_row[0, 3] = half_diag

        # --- per-mesh tables -----------------------------------------------
        bsdf_table = table_arrays([m.bsdf for m in self.meshes])
        em_rad = np.zeros((len(self.meshes), 3), dtype=np.float32)
        em_mask = np.zeros(len(self.meshes), dtype=bool)
        for mi, mesh in enumerate(self.meshes):
            if mesh.is_emitter():
                em_rad[mi] = mesh.emitter.radiance
                em_mask[mi] = True

        # --- scene-level emissive triangle CDF ------------------------------
        emissive = em_mask[tri_mesh[: n_tris]]
        em_tri = np.nonzero(emissive)[0].astype(np.int32)
        n_emissive = em_tri.shape[0]
        if n_emissive:
            em_areas = areas[em_tri]
            cdf = np.concatenate([[0.0], np.cumsum(em_areas)])
            total = cdf[-1]
            cdf = (cdf / total).astype(np.float32)
        else:
            em_tri = np.zeros(1, dtype=np.int32)
            cdf = np.array([0.0, 1.0], dtype=np.float32)
            total = 0.0
        # pad E to power-of-two-ish granularity for static shapes
        epad = (-em_tri.shape[0]) % 16
        if epad:
            em_tri = np.concatenate(
                [em_tri, np.full(epad, em_tri[-1], dtype=np.int32)]
            )
            cdf = np.concatenate([cdf, np.ones(epad, dtype=np.float32)])

        # --- packed per-triangle shading attributes --------------------------
        gn_f = np.cross(e1, e2)
        gn_f = gn_f / np.maximum(
            np.linalg.norm(gn_f, axis=-1, keepdims=True), 1e-24)
        # cols 19:28 carry v0|e1|e2 so the interaction fill can
        # recompute barycentrics for the winning triangle (the sweep
        # kernel tracks only (t, idx))
        tri_attr = np.concatenate(
            [gn_f.astype(np.float32), n0, n1, n2, uv0, uv1, uv2,
             tri_mesh.astype(np.int32).view(np.float32)[:, None],
             v0.astype(np.float32), e1.astype(np.float32),
             e2.astype(np.float32)],
            axis=1,
        ).astype(np.float32)

        # --- packed emissive-sample table ------------------------------------
        et = em_tri
        em_attr = np.concatenate(
            [v0[et], e1[et], e2[et], n0[et], n1[et], n2[et],
             em_rad[tri_mesh[et]], np.zeros((et.shape[0], 3), np.float32)],
            axis=1,
        ).astype(np.float32)

        mesh_attr = np.concatenate(
            [np.asarray(bsdf_table["type"], np.int32).view(np.float32)[:, None],
             np.asarray(bsdf_table["albedo"], np.float32),
             np.asarray(bsdf_table["alpha"], np.float32)[:, None],
             np.asarray(bsdf_table["int_ior"], np.float32)[:, None],
             np.asarray(bsdf_table["ext_ior"], np.float32)[:, None],
             np.asarray(bsdf_table["ks"], np.float32)[:, None],
             em_rad,
             np.zeros((len(self.meshes), 1), np.float32)],
            axis=1,
        ).astype(np.float32)

        bvh_arrays = {
            "bvh_child": bvh.child, "bvh_count": bvh.count,
            "bvh_bmin": bvh.bmin, "bvh_bmax": bvh.bmax}
        bw_rows = _build_tri_bw(v0, e1, e2, n_tris)
        self._data = dict(
            tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n0=n0, tri_n1=n1, tri_n2=n2,
            tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2, tri_mesh=tri_mesh,
            tri_attr=tri_attr, em_attr=em_attr, mesh_attr=mesh_attr,
            # streamed-scale soups carry zero rows up to 16, as the JAX
            # package lays them out for its DMA
            tri_packed=np.concatenate(
                [v0.T, e1.T, e2.T]
                + ([np.zeros((7, t_padded), np.float32)] if streamed
                   else []), axis=0),
            tri_bw=(bw_rows if not streamed else np.concatenate(
                [bw_rows, np.zeros((4, t_padded), np.float32)], axis=0)),
            tri_tile_bounds=tile_bounds,
            scene_bounds=scene_bounds_row,
            em_radiance=em_rad, mesh_emissive=em_mask,
            em_tri=em_tri, em_cdf=cdf,
            em_area=np.float32(total), n_emissive=np.int32(n_emissive),
            bbox_min=bbox_min.astype(np.float32),
            bbox_max=bbox_max.astype(np.float32),
            **bvh_arrays,
        )
        return self._data

    def to_string(self):
        return (
            f"Scene[meshes={len(self.meshes)}, camera={self.camera!r}, "
            f"integrator={self.integrator!r}, sampler={self.sampler!r}]"
        )
