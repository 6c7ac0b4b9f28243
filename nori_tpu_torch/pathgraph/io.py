"""Binary path-graph file formats.

Copy of `nori_tpu/pathgraph/io.py` (numpy).

Byte-exact numpy dtypes for the reference's structs and file layouts
(include/nori/shadingPoint.h:125-154; readers src/pathgraph.cpp:8-242):

  <base>_vert.bin   int32 count + SPoint[count]
  <base>_paths.bin  size_t count + int xres + int yres + cPath[count]
  <base>_light.bin  int32 count + LPoint[count]
  <base>_aabb.bin   AABBINFO (min/max/center/extents + long/short axis)
  <base>_sensor.bin Matrix4f camera, Matrix4f camera2sample (row-major
                    after the reference's transposeInPlace), fov, nearClip
  <base>neighbors.bin  int32 n_points + int32 cluster_id[n_points]
  <base>_clusters.bin  int32 n_clusters + int32 offsets[n_clusters]
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# struct ShadingPoint (shadingPoint.h:125-145): 12 float3 + 3 float +
# 2 int + char, C-aligned to 168 bytes
SPOINT_DTYPE = np.dtype({
    "names": [
        "pos", "wi", "wi_d", "wo", "shN", "geoN", "diffuse", "specular",
        "eLi", "eLd", "eta", "k", "roughness", "pdf", "rrpdf", "nidx",
        "groupIdx", "bsdf_type",
    ],
    "formats": [
        "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4",
        "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4",
        "f4", "f4", "f4", "i4", "i4", "S1",
    ],
    "offsets": [
        0, 12, 24, 36, 48, 60, 72, 84, 96, 108, 120, 132,
        144, 148, 152, 156, 160, 164,
    ],
    "itemsize": 168,
})

# struct LightPoint (shadingPoint.h:147-154)
LPOINT_DTYPE = np.dtype({
    "names": ["L_directsample", "L_bsdfsample", "L_em", "lightpdf",
              "bsdfpdf"],
    "formats": ["(3,)f4", "(3,)f4", "(3,)f4", "f4", "f4"],
    "offsets": [0, 12, 24, 36, 40],
    "itemsize": 44,
})

# struct CompleteLightPath (pathgraph.h:23-29): int,int,size_t,size_t,
# Color3f — with size_t alignment the struct is 8-aligned
CPATH_DTYPE = np.dtype({
    "names": ["xIdx", "yIdx", "firstPathPointIdx", "numOfPathPoints", "em"],
    "formats": ["i4", "i4", "u8", "u8", "(3,)f4"],
    "offsets": [0, 4, 8, 16, 24],
    "itemsize": 40,
})

# struct aabbinfo (pathgraph.h:31-38)
AABB_DTYPE = np.dtype({
    "names": ["min", "max", "center", "extents", "longAxis", "shortAxis"],
    "formats": ["(3,)f4", "(3,)f4", "(3,)f4", "(3,)f4", "i4", "i4"],
    "offsets": [0, 12, 24, 36, 48, 52],
    "itemsize": 56,
})


@dataclass
class PathGraphData:
    """In-memory path graph (mirrors class PathGraph, pathgraph.h:39-80)."""

    sps: np.ndarray            # SPOINT_DTYPE array
    lps: np.ndarray            # LPOINT_DTYPE array
    paths: np.ndarray          # CPATH_DTYPE array
    xres: int = 0
    yres: int = 0
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3))
    aabb_max: np.ndarray = field(default_factory=lambda: np.ones(3))
    camera_matrix: np.ndarray | None = None
    camera2sample: np.ndarray | None = None
    fov: float = 0.0
    near_clip: float = 0.0

    @property
    def num_points(self) -> int:
        return len(self.sps)

    def grid_dimensions(self) -> np.ndarray:
        """Grid resolution ~ N^(1/3) scaled by extents
        (PathGraph::computeDimensions, src/pathgraph.cpp:40-50)."""
        extents = (self.aabb_max - self.aabb_min).astype(np.float64)
        long_axis = int(np.argmax(extents))
        ratio = extents / max(extents[long_axis], 1e-20)
        dim = self.num_points ** (1.0 / 3.0) + 1.0
        return (ratio * dim + 1.0).astype(np.int32)


def load_path_graph(base: str) -> PathGraphData:
    """Load <base>_vert/_paths/_light/_aabb[/_sensor].bin."""
    with open(base + "_vert.bin", "rb") as f:
        count = int(np.fromfile(f, np.int32, 1)[0])
        sps = np.fromfile(f, SPOINT_DTYPE, count)
    with open(base + "_paths.bin", "rb") as f:
        pcount = int(np.fromfile(f, np.uint64, 1)[0])
        xres = int(np.fromfile(f, np.int32, 1)[0])
        yres = int(np.fromfile(f, np.int32, 1)[0])
        paths = np.fromfile(f, CPATH_DTYPE, pcount)
    with open(base + "_light.bin", "rb") as f:
        lcount = int(np.fromfile(f, np.int32, 1)[0])
        lps = np.fromfile(f, LPOINT_DTYPE, lcount)
    with open(base + "_aabb.bin", "rb") as f:
        aabb = np.fromfile(f, AABB_DTYPE, 1)[0]

    g = PathGraphData(
        sps=sps, lps=lps, paths=paths, xres=xres, yres=yres,
        aabb_min=np.asarray(aabb["min"]), aabb_max=np.asarray(aabb["max"]),
    )
    sensor = base + "_sensor.bin"
    if os.path.exists(sensor):
        with open(sensor, "rb") as f:
            m1 = np.fromfile(f, np.float32, 16).reshape(4, 4)
            m2 = np.fromfile(f, np.float32, 16).reshape(4, 4)
            g.camera_matrix = m1.T.copy()  # transposeInPlace in the ref
            g.camera2sample = m2.T.copy()
            g.fov = float(np.fromfile(f, np.float32, 1)[0])
            g.near_clip = float(np.fromfile(f, np.float32, 1)[0])
    return g


def save_path_graph(base: str, g: PathGraphData):
    """Write the binary file set (byte-compatible with the reference)."""
    with open(base + "_vert.bin", "wb") as f:
        np.int32(len(g.sps)).tofile(f)
        g.sps.astype(SPOINT_DTYPE, copy=False).tofile(f)
    with open(base + "_paths.bin", "wb") as f:
        np.uint64(len(g.paths)).tofile(f)
        np.int32(g.xres).tofile(f)
        np.int32(g.yres).tofile(f)
        g.paths.astype(CPATH_DTYPE, copy=False).tofile(f)
    with open(base + "_light.bin", "wb") as f:
        np.int32(len(g.lps)).tofile(f)
        g.lps.astype(LPOINT_DTYPE, copy=False).tofile(f)
    aabb = np.zeros(1, AABB_DTYPE)
    aabb["min"] = g.aabb_min
    aabb["max"] = g.aabb_max
    aabb["center"] = 0.5 * (g.aabb_min + g.aabb_max)
    aabb["extents"] = g.aabb_max - g.aabb_min
    aabb["longAxis"] = int(np.argmax(g.aabb_max - g.aabb_min))
    aabb["shortAxis"] = int(np.argmin(g.aabb_max - g.aabb_min))
    with open(base + "_aabb.bin", "wb") as f:
        aabb.tofile(f)
    if g.camera_matrix is not None:
        with open(base + "_sensor.bin", "wb") as f:
            np.asarray(g.camera_matrix.T, np.float32).tofile(f)
            np.asarray(g.camera2sample.T, np.float32).tofile(f)
            np.float32(g.fov).tofile(f)
            np.float32(g.near_clip).tofile(f)


def load_neighbors(base: str):
    """neighbors.bin + _clusters.bin (src/pathgraph.cpp:88-123)."""
    with open(base + "neighbors.bin", "rb") as f:
        n = int(np.fromfile(f, np.int32, 1)[0])
        clusters = np.fromfile(f, np.int32, n)
    with open(base + "_clusters.bin", "rb") as f:
        nc = int(np.fromfile(f, np.int32, 1)[0])
        offsets = np.fromfile(f, np.int32, nc)
    return clusters, offsets


def save_neighbors(base: str, clusters: np.ndarray, offsets: np.ndarray):
    with open(base + "neighbors.bin", "wb") as f:
        np.int32(len(clusters)).tofile(f)
        clusters.astype(np.int32).tofile(f)
    with open(base + "_clusters.bin", "wb") as f:
        np.int32(len(offsets)).tofile(f)
        offsets.astype(np.int32).tofile(f)


# ---------------------------------------------------------------------------
# Auxiliary dumps: eigenvector / max-idx (src/pathgraph.cpp:200-242) and the
# sparse propagation-matrix file set consumed by matlab/matrixCPU.m:1-45.
# ---------------------------------------------------------------------------

def load_eigenvector(base: str, n_points: int) -> np.ndarray:
    """<base>_scene_output_d<N>_eigenvector.bin: raw float[N]."""
    path = f"{base}_scene_output_d{n_points}_eigenvector.bin"
    return np.fromfile(path, np.float32, n_points)


def save_eigenvector(base: str, values: np.ndarray):
    path = f"{base}_scene_output_d{len(values)}_eigenvector.bin"
    np.asarray(values, np.float32).tofile(path)


def load_max_idx(base: str, n_points: int) -> np.ndarray:
    path = f"{base}_scene_output_d{n_points}_max_idx.bin"
    return np.fromfile(path, np.int32)


def load_matrix_dump(base: str):
    """Sparse propagation-matrix dump (matlab/matrixCPU.m layout):
    returns dict with IDX/JDX int32, Ar/Ag/Ab float32, x0/b (3, nnz?)
    float32, clusters int32, pixel_idx int32 (whatever files exist)."""
    import os

    out = {}
    names = {
        "IDX": ("_matrixIdx.bin", np.int32),
        "JDX": ("_matrixJdx.bin", np.int32),
        "Ar": ("_matrix_r.bin", np.float32),
        "Ag": ("_matrix_g.bin", np.float32),
        "Ab": ("_matrix_b.bin", np.float32),
        "b": ("_matrix_b_value.bin", np.float32),
        "x0": ("_matrix_x_0_value.bin", np.float32),
        "clusters": ("_clusters.bin", np.int32),
        "pixel_idx": ("_matrix_pixel_idx.bin", np.int32),
    }
    for key, (suffix, dt) in names.items():
        p = base + suffix
        if os.path.exists(p):
            out[key] = np.fromfile(p, dt)
    for key in ("b", "x0"):
        if key in out:
            out[key] = out[key].reshape(-1, 3).T  # matlab reshape(·, 3, [])
    return out


def save_matrix_dump(base: str, idx, jdx, a_rgb, b=None, x0=None):
    """Write the sparse-matrix file set (for analysis round trips)."""
    np.asarray(idx, np.int32).tofile(base + "_matrixIdx.bin")
    np.asarray(jdx, np.int32).tofile(base + "_matrixJdx.bin")
    a_rgb = np.asarray(a_rgb, np.float32)
    a_rgb[:, 0].tofile(base + "_matrix_r.bin")
    a_rgb[:, 1].tofile(base + "_matrix_g.bin")
    a_rgb[:, 2].tofile(base + "_matrix_b.bin")
    if b is not None:
        np.asarray(b, np.float32).reshape(-1).tofile(
            base + "_matrix_b_value.bin")
    if x0 is not None:
        np.asarray(x0, np.float32).reshape(-1).tofile(
            base + "_matrix_x_0_value.bin")
