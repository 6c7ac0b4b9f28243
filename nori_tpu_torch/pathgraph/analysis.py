"""Propagation-matrix analysis (replaces matlab/*.m).

Port of `nori_tpu/pathgraph/analysis.py`: scipy.sparse on the host;
`build_propagation_matrix` evaluates the BSDFs on the device of the
GraphPoints.

The reference dumps the sparse per-cluster propagation matrix
(IDX/JDX/A_rgb/b/x0 — matlab/matrixCPU.m:1-40) and analyzes it in
MATLAB: builds sparse A, runs the Jacobi-style fixed point x <- A x + b,
and studies A's spectrum (matrixAna.m) plus cluster-size histograms
(hashtable.m).  This module provides the same analyses on top of
scipy.sparse, plus a builder that produces A and b directly from a
path graph (so no binary dump round trip is needed).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def build_propagation_matrix(gp, members, sizes, marginal):
    """Sparse A (N x N) with A[j, i] = f(sp_j, wi_i) / marginal_i taken
    per color channel (list of 3 csr matrices), plus b = direct term
    placeholder.  Mirrors precomputedMatrixElemtns/computeNoneZeroElements
    (pbsdf.cu:3535, :1059) in COO form."""
    import torch

    from nori_tpu_torch.pathgraph.bsdfgraph import eval_graph_bsdf

    c, pad = members.shape
    rows, cols, vals = [], [], []
    nidx = gp.nidx.cpu().numpy()
    rr = gp.rrpdf.cpu().numpy()
    for b0 in range(0, c, 256):
        b1 = min(b0 + 256, c)
        mem = members[b0:b1]
        m = mem.shape[0]
        mem_t = torch.as_tensor(mem, dtype=torch.int64, device=gp.device)
        sp_j = gp.gather(mem_t[:, :, None].expand(m, pad, pad))
        wi_i = gp.wi[mem_t][:, None, :, :].expand(m, pad, pad, 3)
        f = eval_graph_bsdf(sp_j, wi_i).cpu().numpy()
        lane = np.arange(pad)
        valid = lane[None, :] < sizes[b0:b1][:, None]
        vmask = valid[:, :, None] & valid[:, None, :]
        marg_i = marginal[mem][:, None, :]
        alive_i = (nidx[mem] > 0) & (rr[mem] > 1e-7)
        w = np.where(
            (marg_i > 0) & alive_i[:, None, :],
            1.0 / np.maximum(marg_i, 1e-20), 0.0)
        aval = f * w[..., None]
        jj = np.broadcast_to(mem[:, :, None], (m, pad, pad))
        ii = np.broadcast_to(mem[:, None, :], (m, pad, pad))
        keep = vmask & (np.abs(aval).sum(-1) > 0)
        rows.append(jj[keep])
        cols.append(ii[keep])
        vals.append(aval[keep])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    n = len(nidx)
    mats = [
        sp.coo_matrix((vals[:, ch], (rows, cols)), shape=(n, n)).tocsr()
        for ch in range(3)
    ]
    return mats


def jacobi_iterate(A, b, x0=None, iterations=10):
    """x <- A x + b (matlab/matrixCPU.m's fixed-point loop)."""
    x = np.zeros(A.shape[0]) if x0 is None else np.asarray(x0, float)
    history = []
    for _ in range(iterations):
        x = A @ x + b
        history.append(np.linalg.norm(x))
    return x, history


def spectral_radius(A, k: int = 1):
    """Largest-magnitude eigenvalues of A (matrixAna.m's eigs)."""
    vals = spla.eigs(
        A.astype(np.float64), k=k, which="LM", return_eigenvectors=False,
        maxiter=2000,
    )
    return np.abs(vals)


def dominant_eigenvector(A):
    vals, vecs = spla.eigs(A.astype(np.float64), k=1, which="LM",
                           maxiter=2000)
    return np.abs(vals[0]), np.real(vecs[:, 0])


def cluster_size_histogram(offsets, bins=32):
    """Cluster-occupancy histogram (hashtable.m)."""
    sizes = np.diff(offsets)
    return np.histogram(sizes, bins=bins)
