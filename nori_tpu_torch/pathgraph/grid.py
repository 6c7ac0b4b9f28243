"""Uniform hash grid + k-nearest-neighbor search.

Port of `nori_tpu/pathgraph/grid.py`.  `UniformGrid` is the JAX
package's numpy build, copied: points sorted by linear cell key
(argsort + searchsorted segment offsets) in place of the reference's
count / exclusive-scan / scatter (pbsdf.cu:630-1175).  `knn` runs on
tensors on the device: the 27-cell candidate set of each query is
gathered as 9 contiguous sorted ranges (3 consecutive x-cells x 9 (y,z)
rows), each capped at `run_cap` entries, and the k smallest distances
are kept with the query point forced into slot 0 (batchNearestNeighbor,
pbsdf.cu:1167-1173).

Ties in distance keep the lower candidate slot first, as
`jax.lax.top_k` does: the selection is a stable sort of each row, not
`torch.topk`, which promises no order among equal values.
"""

from __future__ import annotations

import numpy as np
import torch

#: queries per knn block: its (chunk, 9 * run_cap + 1) candidate
#: tables stay under 1 GB at run_cap 96 (the search takes 0.39 s at
#: the protocol's 4.18M points on one H100, tools/pathgraph_chunks.py)
KNN_CHUNK = 131072

#: (dy, dz) of the 9 rows of x-runs around a cell
ROW_OFFSETS = tuple((dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


class UniformGrid:
    def __init__(self, pos: np.ndarray, dims, bbox_min, bbox_max):
        self.dims = np.asarray(dims, np.int32)
        self.bbox_min = np.asarray(bbox_min, np.float32)
        self.bbox_max = np.asarray(bbox_max, np.float32)
        extent = np.maximum(self.bbox_max - self.bbox_min, 1e-20)
        self.cell_size = extent / self.dims
        n_cells = int(np.prod(self.dims.astype(np.int64)))

        cell = np.clip(
            ((pos - self.bbox_min) / self.cell_size).astype(np.int64),
            0, self.dims - 1,
        )
        # linear key x + dx*(y + dy*z) (getKey, pbsdf.cu:663)
        key = cell[:, 0] + self.dims[0] * (
            cell[:, 1] + self.dims[1] * cell[:, 2]
        )
        self.order = np.argsort(key, kind="stable").astype(np.int32)
        self.sorted_keys = key[self.order]
        # cell -> [start, end) in sorted order
        self.cell_start = np.searchsorted(
            self.sorted_keys, np.arange(n_cells), side="left"
        ).astype(np.int32)
        self.cell_end = np.searchsorted(
            self.sorted_keys, np.arange(n_cells), side="right"
        ).astype(np.int32)
        self.n_cells = n_cells
        self.point_cell = cell


def sqdist(a, b):
    """|a - b|^2 over the last axis."""
    d = a - b
    return torch.sum(d * d, dim=-1)


def cell_runs(q_cell, dims, n_cells: int, starts, ends, order, run_cap: int,
              n: int):
    """Candidates of the 27 cells around each query cell: 9 runs of 3
    consecutive x cells, each capped at run_cap sorted entries.

    q_cell: (m, 3) int64 cells; starts/ends/order: a grid's cell_start,
    cell_end and order on the device, n its point count.  Yields each
    run's (point indices (m, run_cap) int64, in range (m, run_cap))."""
    lanes = torch.arange(run_cap, dtype=torch.int64, device=q_cell.device)
    dx, dy_, dz_ = (int(v) for v in dims)
    for dy, dz in ROW_OFFSETS:
        y = q_cell[:, 1] + dy
        z = q_cell[:, 2] + dz
        ok_row = (y >= 0) & (y < dy_) & (z >= 0) & (z < dz_)
        x0 = torch.clamp_min(q_cell[:, 0] - 1, 0)
        x1 = torch.clamp_max(q_cell[:, 0] + 1, dx - 1)
        row = dx * (y + dy_ * z)
        base = torch.clamp(x0 + row, 0, n_cells - 1)
        last = torch.clamp(x1 + row, 0, n_cells - 1)
        s = starts[base]
        e = ends[last]
        idx_sorted = s[:, None] + lanes[None, :]
        ok = ok_row[:, None] & (idx_sorted < e[:, None])
        idx = order[torch.clamp_max(idx_sorted, n - 1)]
        yield idx, ok


def grid_tensors(grid: UniformGrid, device):
    """(order, cell_start, cell_end) of a grid as int64 tensors."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (grid.order, grid.cell_start, grid.cell_end))


def knn(pos: np.ndarray, grid: UniformGrid, k: int,
        run_cap: int | None = None, chunk: int = KNN_CHUNK, device=None):
    """k nearest neighbors over the 27-cell neighborhood, on `device`
    (default: the first CUDA device; device.resolve_device).

    Returns (neighbors (N, k) int32, counts (N,) int32) tensors on the
    device.  neighbors[:, 0] is the point itself; remaining slots hold
    its nearest candidates (self again where fewer than k candidates
    exist); counts are the valid slots.
    """
    from nori_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = pos.shape[0]
    if run_cap is None:
        # 3 cells/run; mean occupancy ~1 for N^(1/3) grids, cap with
        # generous headroom for dense cells
        occ = max(1, int(np.ceil(n / max(grid.n_cells, 1))))
        run_cap = int(np.clip(16 * occ, 24, 96))

    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    cell_t = torch.as_tensor(grid.point_cell, dtype=torch.int64, device=dev)
    order, starts, ends = grid_tensors(grid, dev)

    neighbors = torch.empty((n, k), dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        q_pos = pos_t[c0:c1]
        q_self = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        runs = list(cell_runs(cell_t[c0:c1], grid.dims, grid.n_cells,
                              starts, ends, order, run_cap, n))
        cand = torch.cat([torch.where(ok, idx, 0) for idx, ok in runs], 1)
        okm = torch.cat([ok for _, ok in runs], 1)
        d2 = sqdist(pos_t[cand], q_pos[:, None, :])
        # the query point itself ranks first (forced slot 0,
        # pbsdf.cu:1167-1173) and duplicates of it are pushed out
        is_self = cand == q_self[:, None]
        d2 = torch.where(okm & ~is_self, d2, torch.inf)
        cand = torch.cat([q_self[:, None], cand], 1)
        d2 = torch.cat([torch.full_like(d2[:, :1], -1.0), d2], 1)
        d2s, sel = torch.sort(d2, dim=1, stable=True)
        valid = torch.isfinite(d2s[:, :k])
        nbr = torch.gather(cand, 1, sel[:, :k])
        # invalid slots fall back to self
        neighbors[c0:c1] = torch.where(valid, nbr, q_self[:, None])
        counts[c0:c1] = valid.sum(1)
    return neighbors, counts


def knn_brute_force(pos: np.ndarray, k: int) -> np.ndarray:
    """O(N^2) oracle for tests."""
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)
    out = order[:, :k].astype(np.int32)
    # self first
    n = pos.shape[0]
    for i in range(n):
        row = list(out[i])
        if i in row:
            row.remove(i)
        out[i] = [i] + row[: k - 1]
    return out
