"""Spatial clustering of shading points.

Port of `nori_tpu/pathgraph/cluster.py`: the numpy body is copied and
the nearest-seed search (`_nearest_seed`) runs on tensors on the
device.

Behavioral port of the CUDA cluster build (buildBatchClusters
pbsdf.cu:3555, Cluster kernel :1008-1044, SubdivideClusters :942,
subClusters :3282, FinalizeCluster :3320; host shuffle
shadingPoint.h:637-677): seed N/K clusters from a shuffled subset of
the points, assign every point to the nearest seed found in the 27
cells around it (falling back to the globally nearest seed when none is
nearby), then split oversize clusters until no cluster exceeds the
size cap.  Output matches the reference contract: a per-point cluster
id plus per-cluster offsets into the cluster-sorted point order.
"""

from __future__ import annotations

import numpy as np
import torch

from nori_tpu_torch.pathgraph.grid import (
    UniformGrid, cell_runs, grid_tensors, sqdist)
from nori_tpu_torch.device import resolve_device

#: points per nearest-seed launch group
SEED_CHUNK = 262144


def build_clusters(pos: np.ndarray, dims, bbox_min, bbox_max, k: int,
                   seed: int = 1994, max_size_factor: int = 2,
                   device=None):
    """Returns (cluster_id (N,), order (N,), offsets (C+1,)), numpy.
    The nearest-seed search runs on `device` (default: the first CUDA
    device; device.resolve_device), the rest on the host.

    `order` sorts points by cluster; cluster c owns
    order[offsets[c]:offsets[c+1]].
    """
    n = pos.shape[0]
    n_clusters = n // k + 1
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    seeds = perm[:n_clusters]
    seed_pos = pos[seeds]

    # nearest seed within the 27-cell neighborhood of a seed grid.
    # The grid is sized for the SEED count (the reference's cluster
    # hash table has numClusters cells, pbsdf.cu buildBatchClusters) —
    # using the point-count dims leaves cells ~k-times too sparse and
    # pushes almost every query into the brute-force fallback.
    scale = (len(seed_pos) / max(n, 1)) ** (1.0 / 3.0)
    sdims = np.maximum(1, np.ceil(np.asarray(dims) * scale)).astype(np.int32)
    sgrid = UniformGrid(seed_pos, sdims, bbox_min, bbox_max)
    cluster_id = _nearest_seed(pos, seed_pos, sgrid,
                               device=resolve_device(device))

    # split oversize clusters (reference subdivides twice; we loop until
    # converged or 4 rounds).  Fully vectorized: the obvious
    # per-cluster `np.nonzero(cluster_id == c)` loop is O(big * N) and
    # measured at tens of minutes per protocol-scale run (7.4M points,
    # ~20k oversize clusters); this formulation is two sorts + reduceat
    # passes per round regardless of how many clusters split.
    cap = max_size_factor * k
    n_seeds = len(seed_pos)
    for _ in range(4):
        sizes = np.bincount(cluster_id, minlength=n_seeds)
        if sizes.max(initial=0) <= cap:
            break
        # per-cluster widest axis from reduceat extents over the
        # cluster-sorted order
        order = np.argsort(cluster_id, kind="stable")
        starts = np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        nonempty = sizes > 0
        ps = pos[order]
        red_starts = np.minimum(starts, max(len(order) - 1, 0))
        mins = np.minimum.reduceat(ps, red_starts, axis=0)
        maxs = np.maximum.reduceat(ps, red_starts, axis=0)
        ext = np.where(nonempty[:, None], maxs - mins, 0.0)
        axis_of = np.argmax(ext, axis=1)          # (C,)
        # rank each point inside its cluster along that axis: sort by
        # (cluster, coord); the upper size//2 ranks split off.  Rank
        # splitting is the original median split with deterministic
        # tie handling (the old code's fallback for degenerate
        # medians was exactly members[size//2:]).
        coord = pos[np.arange(n), axis_of[cluster_id]]
        o2 = np.lexsort((coord, cluster_id))
        rank = np.arange(n, dtype=np.int64) - starts[cluster_id[o2]]
        big_here = sizes[cluster_id[o2]] > cap
        upper = big_here & (rank >= sizes[cluster_id[o2]] // 2)
        split_pts = o2[upper]
        split_cl = cluster_id[split_pts]
        # one new id per split cluster
        uniq, inv = np.unique(split_cl, return_inverse=True)
        cluster_id[split_pts] = n_seeds + inv.astype(cluster_id.dtype)
        n_seeds += len(uniq)

    # compact empty clusters + build offsets
    used, cluster_id = np.unique(cluster_id, return_inverse=True)
    cluster_id = cluster_id.astype(np.int32)
    order = np.argsort(cluster_id, kind="stable").astype(np.int32)
    sizes = np.bincount(cluster_id, minlength=len(used))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return cluster_id, order, offsets


def _nearest_seed(pos, seed_pos, sgrid: UniformGrid, device,
                  chunk: int = SEED_CHUNK):
    """Per point, the nearest seed among the 27 seed-grid cells around
    it (the first in candidate order at equal distance, as the JAX
    package's argmin takes it); a point with no seed nearby takes the
    globally nearest seed, in blocks of 1024 points so the fallback never
    builds an O(n * seeds) matrix.  Returns (N,) int32 numpy."""
    n = pos.shape[0]
    ns = seed_pos.shape[0]
    run_cap = 32
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=device)
    seed_t = torch.as_tensor(seed_pos, dtype=torch.float32, device=device)
    order, starts, ends = grid_tensors(sgrid, device)
    bmin = torch.as_tensor(sgrid.bbox_min, device=device)
    csize = torch.as_tensor(sgrid.cell_size, device=device)
    top = torch.as_tensor(sgrid.dims - 1, dtype=torch.int64, device=device)

    out = torch.empty(n, dtype=torch.int64, device=device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        q_pos = pos_t[c0:c1]
        q_cell = torch.clamp(((q_pos - bmin) / csize).to(torch.int64),
                             torch.zeros_like(top), top)
        best_d = torch.full((c1 - c0,), torch.inf, device=device)
        best_i = torch.zeros(c1 - c0, dtype=torch.int64, device=device)
        for idx, ok in cell_runs(q_cell, sgrid.dims, sgrid.n_cells, starts,
                                 ends, order, run_cap, ns):
            d2 = torch.where(ok, sqdist(seed_t[idx], q_pos[:, None, :]),
                             torch.inf)
            mn, am = torch.min(d2, dim=1)
            cand = torch.gather(idx, 1, am[:, None])[:, 0]
            better = mn < best_d
            best_d = torch.where(better, mn, best_d)
            best_i = torch.where(better, cand, best_i)
        # points with no nearby seed: global nearest (rare)
        missing = torch.nonzero(~torch.isfinite(best_d))[:, 0]
        for m0 in range(0, len(missing), 1024):
            sel = missing[m0:m0 + 1024]
            dv = q_pos[sel][:, None, :] - seed_t[None, :, :]
            best_i[sel] = torch.argmin(torch.sum(dv * dv, dim=-1), dim=1)
        out[c0:c1] = best_i
    return out.to(torch.int32).cpu().numpy()


def pad_clusters(order: np.ndarray, offsets: np.ndarray, pad: int):
    """(C, pad) padded member table + (C,) sizes; members beyond a
    cluster's size repeat its first point (masked by size downstream)."""
    c = len(offsets) - 1
    sizes = np.diff(offsets)
    csizes = np.minimum(sizes, pad).astype(np.int32)
    lane = np.arange(pad)[None, :]
    idx = offsets[:-1][:, None] + np.minimum(lane, csizes[:, None] - 1)
    idx = np.clip(idx, 0, len(order) - 1)
    table = order[idx].astype(np.int32)
    return table, csizes
