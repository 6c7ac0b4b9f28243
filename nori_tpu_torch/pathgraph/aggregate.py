"""Radiance aggregation iterations over the path graph.

Port of `nori_tpu/pathgraph/aggregate.py` (the CUDA iteration drivers
of the reference, SURVEY.md §2.9):

KNN mode — computeMISAllOnGPURecord (pbsdf.cu:2922-2968):
  pdfsum[i, s]   = sum_j pdf(sp_{nb[i,j]}, wi_{nb[i,s]}) * rrpdf_j
  temp^0         = eLi
  rad^{t}[i]     = sum_s [nb[i,s] alive] f(sp_i, wi_{nb[i,s]})
                   * temp^{t}[nb[i,s]+1] / pdfsum[i, s]
  temp^{t+1}     = rad^{t} + eLd                            (updateRadiance)
  mc^{t}[i]      = f(sp_i, wi_i) * temp^{t+1}[i+1]
                   / (pdf(sp_i, wi_i) * rrpdf_i)            (lastRun)

Cluster mode — ClusterScatterWithDirectOptNR (shadingPoint.h:600-620):
  direct[j]      = sum_{i in cluster(j)} [ f(sp_j, wi_d_i) * Ld_i / mx_i
                   + f(sp_j, wi_i) * Lb_i / my_i ] + L_em_j
  marginal_i     = sum_{j in cluster(i), nidx_j != i}
                   pdf(sp_j, wi_i) * rrpdf_j
  rad^{t}[j]     = sum_{i in cluster(j), j != i+1}
                   f(sp_j, wi_i) * temp^{t}[i+1] / marginal_i
  temp^{t+1}     = rad^{t} + direct                (updateWithOptDirect)
  final mc       = lastRun on temp

The cluster neighborhood is symmetric, so each point gathers over its
cluster's members through a (n_clusters, pad) member table; the KNN
scatter form deposits with `index_add_`.  The per-cluster energy clamp
(clampCluster/computeRatio/updateComputeCluster, pbsdf.cu:2127-2183)
runs every cluster iteration, in float64.

Every block is plain float32 torch on the device of the GraphPoints,
and the point arrays stay there between blocks and iterations: the
drivers take numpy arrays or tensors and return tensors on that
device.  Chunks bound the temporaries only: no per-point sum crosses a
chunk, so a chunk size changes no result.  On CUDA, `index_add_`
accumulates with atomics, so the scatter sums (and the energy clamp's
float64 sums) are added in an order that varies between runs.
"""

from __future__ import annotations

import numpy as np
import torch

from nori_tpu_torch.pathgraph.bsdfgraph import (
    GraphPoints, _norm, eval_graph_bsdf, pdf_graph_bsdf,
)

EPS_RR = 1e-7

# Chunk sizes, from tools/pathgraph_chunks.py on one H100 at the
# protocol's size (4.18M points, k = 16, pad 32): the fastest size tried
# or within 16% of it (direct 5%, marginal 16%, the KNN pass 10%), at
# 2-4 GiB of peak device memory; the larger sizes tried gain at most
# 0.04 s a pass and double the peak.
#: points per (m, k, k) block of the KNN pdf sums
KNN_PAIR_CHUNK = 65536
#: points per (m, k) block of the KNN passes
KNN_CHUNK = 262144
#: points per lastRun block
LAST_RUN_CHUNK = 1 << 22
#: clusters per (m, pad, pad) block of the cluster passes
CLUSTER_CHUNK = 8192
#: fall back from precomputed elements to re-evaluation past this size
#: (the JAX package's limit: mode "n" keeps its semantics)
ELEMENTS_BUDGET_BYTES = 2 << 30


def _tensor(x, gp: GraphPoints, dtype):
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=gp.device)


def _f32(x, gp: GraphPoints):
    return _tensor(x, gp, torch.float32)


def _i64(x, gp: GraphPoints):
    return _tensor(x, gp, torch.int64)


def _finite(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _next_gather(arr, idx_plus_1, n):
    return arr[torch.clamp_max(idx_plus_1, n - 1)]


def _arange(c0, c1, gp):
    return torch.arange(c0, c1, dtype=torch.int64, device=gp.device)


# ---------------------------------------------------------------------------
# Block functions
# ---------------------------------------------------------------------------

def _pdf_sums_knn_block(gp, nb_c):
    sp_k = gp.gather(nb_c)                   # ONE gather of (m, k)
    spo = sp_k.expand(1)                     # (m, 1, k, ...)
    wi_b = sp_k.wi[:, :, None, :]            # (m, k, 1, 3)
    pdf = pdf_graph_bsdf(spo, wi_b)          # (m, k, k)
    rr = sp_k.rrpdf[:, None, :]
    sums = torch.sum(pdf * rr, dim=2)
    alive = (sp_k.nidx > 0) & (sp_k.rrpdf > EPS_RR)
    return torch.where(alive, sums, 0.0)


def _mis_block(gp, temp, self_idx, nb_c, ps_c):
    n = temp.shape[0]
    sp_self = gp.gather(self_idx).expand(1)
    nb_k = gp.gather(nb_c)
    f = eval_graph_bsdf(sp_self, nb_k.wi)    # (m, k, 3)
    alive = (nb_k.nidx > 0) & (nb_k.rrpdf > EPS_RR) & (ps_c > 0.0)
    t_next = _next_gather(temp, nb_c + 1, n)
    contrib = f * t_next / torch.clamp_min(ps_c, 1e-20)[..., None]
    contrib = torch.where(alive[..., None], contrib, 0.0)
    return torch.sum(contrib, dim=1)


def _last_run_block(gp, temp, idx):
    n = temp.shape[0]
    sp = gp.gather(idx)
    spdf = pdf_graph_bsdf(sp, sp.wi)
    f = eval_graph_bsdf(sp, sp.wi)
    t_next = _next_gather(temp, idx + 1, n)
    inv = 1.0 / torch.clamp_min(spdf * sp.rrpdf, 1e-20)
    rad = f * t_next * inv[..., None]
    ok = (spdf > 0.0) & (sp.nidx > 0)
    return torch.where(ok[..., None], rad, 0.0)


def _lanes_valid(mem_c, siz_c):
    lane = torch.arange(mem_c.shape[1], device=mem_c.device)
    return lane[None, :] < siz_c[:, None]


def _marginal_block(gp, mem_c, siz_c):
    sp_k = gp.gather(mem_c)
    spo = sp_k.expand(1)                       # cols j
    wi_b = sp_k.wi[:, :, None, :]              # rows i
    pdf = pdf_graph_bsdf(spo, wi_b)            # (m, pad_i, pad_j)
    rr = sp_k.rrpdf[:, None, :]
    excl = sp_k.nidx[:, None, :] == mem_c[:, :, None]
    valid_j = _lanes_valid(mem_c, siz_c)[:, None, :]
    w = torch.where(valid_j & ~excl, pdf * rr, 0.0)
    return torch.sum(w, dim=2)


def _direct_block(gp, ld, lb, lightpdf, mem_c, siz_c):
    valid = _lanes_valid(mem_c, siz_c)
    sp_k = gp.gather(mem_c)
    spo = sp_k.expand(1)
    wi_b = sp_k.wi[:, :, None, :]
    pdf_b = pdf_graph_bsdf(spo, wi_b)
    valid_j = valid[:, None, :]
    lightpdf_k = lightpdf[mem_c]
    mx = torch.sum(torch.where(valid_j, lightpdf_k[:, :, None], 0.0), dim=2)
    my = torch.sum(torch.where(valid_j, pdf_b, 0.0), dim=2)

    sp_j = sp_k.expand(2)
    wid_i = sp_k.wi_d[:, None, :, :]
    wi_i = sp_k.wi[:, None, :, :]
    f_d = eval_graph_bsdf(sp_j, wid_i)         # (m, j, i, 3)
    f_b = eval_graph_bsdf(sp_j, wi_i)
    ld_i = ld[mem_c][:, None, :, :]
    lb_i = lb[mem_c][:, None, :, :]
    mx_i = mx[:, None, :, None]
    my_i = my[:, None, :, None]
    contrib = (
        torch.where(mx_i > 0.0, f_d * ld_i / torch.clamp_min(mx_i, 1e-20),
                    0.0)
        + torch.where(my_i > 0.0, f_b * lb_i / torch.clamp_min(my_i, 1e-20),
                      0.0))
    contrib = torch.where(valid[:, None, :, None], contrib, 0.0)
    return torch.sum(contrib, dim=2)


def _mx_block(gp, temp, marginal, mem_c, siz_c):
    n = temp.shape[0]
    valid = _lanes_valid(mem_c, siz_c)
    sp_k = gp.gather(mem_c)
    sp_j = sp_k.expand(2)
    wi_i = sp_k.wi[:, None, :, :]
    f = eval_graph_bsdf(sp_j, wi_i)            # (m, j, i, 3)
    t_next = _next_gather(temp, mem_c + 1, n)
    marg_i = marginal[mem_c]
    alive_i = (sp_k.nidx > 0) & (marg_i > 0.0) & (sp_k.rrpdf > EPS_RR)
    w = t_next / torch.clamp_min(marg_i, 1e-20)[..., None]
    w = torch.where(alive_i[..., None], w, 0.0)
    self_next = mem_c[:, :, None] == (mem_c[:, None, :] + 1)
    contrib = f * w[:, None, :, :]
    contrib = torch.where(self_next[..., None], 0.0, contrib)
    contrib = torch.where(valid[:, None, :, None], contrib, 0.0)
    return torch.sum(contrib, dim=2)


def _pdf_marginal_knn_block(gp, self_idx, nb_c, jitter: bool):
    """allGPUPdfMarginal / allGPUPdfMarginalJitter (pbsdf.cu:1738,
    1758): marginal_i = sum over i's neighbors j (excluding j whose
    continuation IS i, and — jittered — those outside i's cluster) of
    pdf(sp_j, wi_i) * rrpdf_j."""
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    pdf = pdf_graph_bsdf(nb_k, sp_i.wi[:, None, :])    # (m, k)
    w = pdf * nb_k.rrpdf
    excl = nb_k.nidx == self_idx[:, None]
    if jitter:
        excl = excl | (nb_k.groupIdx != sp_i.groupIdx[:, None])
    return torch.sum(torch.where(excl, 0.0, w), dim=1)


def _scatter_contrib_block(gp, temp, self_idx, nb_c, marg_c, jitter: bool,
                           wsum_c, maxd_c):
    """Per-(point, neighbor) deposits of allGPUScatterRadiance
    (pbsdf.cu:1398; jittered lastRunJitter :1528; weighted :1618):
    deposit f(sp_nb, wi_i) * temp[i+1] / marginal_i at each neighbor.
    Returns (m, k, 3) contributions."""
    n = temp.shape[0]
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    f = eval_graph_bsdf(nb_k, sp_i.wi[:, None, :])     # (m, k, 3)
    t_next = _next_gather(temp, self_idx + 1, n)       # (m, 3)
    ok_i = (sp_i.nidx > 0) & (sp_i.rrpdf > EPS_RR) & (marg_c > 0.0)
    inv = torch.where(ok_i, 1.0 / torch.clamp_min(marg_c, 1e-20), 0.0)
    contrib = f * (t_next * inv[:, None])[:, None, :]
    skip = nb_c == (self_idx[:, None] + 1)
    if jitter:
        skip = skip | (nb_k.groupIdx != sp_i.groupIdx[:, None])
    if wsum_c is not None:
        # distance falloff (allGPUScatterRadianceWithWeight,
        # pbsdf.cu:1458): weight = (max_dist - 0.8 dist) * weightsum,
        # 1 when the normalizer degenerates, 0 beyond max_dist
        dist = _norm(nb_k.pos - sp_i.pos[:, None, :])
        w = (maxd_c[:, None] - 0.8 * dist) * wsum_c[:, None]
        w = torch.where(wsum_c[:, None] == 0.0, 1.0, w)
        w = torch.where(maxd_c[:, None] < dist, 0.0, w)
        contrib = contrib * w[..., None]
    return torch.where(skip[..., None], 0.0, contrib)


def _weight_norm_block(gp, self_idx, nb_c):
    """allGPUPdfMarginalAndWeight (pbsdf.cu:1780-1823), per point i
    over its neighbors j (excluding j whose continuation is i):
      max_dist = max distance; w_j = max(max_dist - 0.8 dist_j, 0)
      ws = k / sum_j w_j (0 when degenerate); minweight = max_dist
      pdfmarginal = ws * sum_j pdf(sp_j, wi_i) * w_j * rrpdf_j
    Returns (weightsum, max_dist, weighted_marginal)."""
    k = nb_c.shape[1]
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    dist = _norm(nb_k.pos - sp_i.pos[:, None, :])
    skip = nb_k.nidx == self_idx[:, None]
    maxd = torch.amax(torch.where(skip, 0.0, dist), dim=1)
    w = torch.clamp_min(maxd[:, None] - 0.8 * dist, 0.0)
    w = torch.where(skip, 0.0, w)
    pdf = pdf_graph_bsdf(nb_k, sp_i.wi[:, None, :])
    pdfm = torch.sum(pdf * w * nb_k.rrpdf, dim=1)
    ws_raw = torch.sum(w, dim=1)
    ws = torch.where((ws_raw != 0.0) & (maxd != 0.0),
                     k / torch.clamp_min(ws_raw, 1e-30), 0.0)
    return ws, maxd, pdfm * ws


def _elements_block(gp, marginal, mem_c, siz_c):
    """Precomputed sparse-matrix elements for one cluster block
    (precomputedMatrixElemtns / computeNoneZeroElements,
    pbsdf.cu:3535-3553, 1059-1087): E[j, i] = f(sp_j, wi_i) /
    marginal_i with all masks folded in; MX then reduces
    rad[j] = sum_i E[j, i] * temp[i+1]."""
    valid = _lanes_valid(mem_c, siz_c)
    sp_k = gp.gather(mem_c)
    sp_j = sp_k.expand(2)
    wi_i = sp_k.wi[:, None, :, :]
    f = eval_graph_bsdf(sp_j, wi_i)                # (m, j, i, 3)
    marg_i = marginal[mem_c]
    alive_i = (sp_k.nidx > 0) & (marg_i > 0.0) & (sp_k.rrpdf > EPS_RR)
    inv = torch.where(alive_i, 1.0 / torch.clamp_min(marg_i, 1e-20), 0.0)
    e = f * inv[:, None, :, None]
    self_next = mem_c[:, :, None] == (mem_c[:, None, :] + 1)
    e = torch.where(self_next[..., None], 0.0, e)
    return torch.where(valid[:, None, :, None], e, 0.0)


def _mx_from_elements_block(elements, temp, mem_c):
    n = temp.shape[0]
    t_next = _next_gather(temp, mem_c + 1, n)      # (m, i, 3)
    return torch.sum(elements * t_next[:, None, :, :], dim=2)


# ---------------------------------------------------------------------------
# KNN mode
# ---------------------------------------------------------------------------

def pdf_sums_knn(gp: GraphPoints, neighbors, chunk: int = KNN_PAIR_CHUNK):
    """(N, k) pdf sums (allGPUPdfSum, pbsdf.cu:1600-1618)."""
    nb = _i64(neighbors, gp)
    n, k = nb.shape
    out = torch.empty((n, k), dtype=torch.float32, device=gp.device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        out[c0:c1] = _pdf_sums_knn_block(gp, nb[c0:c1])
    return out


def _no_timer(stage: str):
    pass


def iterate_knn(gp: GraphPoints, neighbors, iterations: int,
                chunk: int = KNN_CHUNK, timer=_no_timer):
    """computeMISAllOnGPURecord: returns (blur_results, mc_results) —
    lists of (N, 3) tensors, one per iteration.  timer(stage) is called
    as each stage ends ("pdf sums", "iteration i", "last_run")."""
    nb = _i64(neighbors, gp)
    n, k = nb.shape
    pdfsum = pdf_sums_knn(gp, nb)
    timer("pdf sums")

    def mis_pass(temp):
        rad = torch.empty((n, 3), dtype=torch.float32, device=gp.device)
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            rad[c0:c1] = _mis_block(gp, temp, _arange(c0, c1, gp),
                                    nb[c0:c1], pdfsum[c0:c1])
        return _finite(rad)

    temp = gp.eLi.clone()
    blur_results, mc_results = [], []
    for it in range(iterations):
        rad = mis_pass(temp)
        blur_results.append(rad)
        temp = rad + gp.eLd
        timer(f"iteration {it + 1}")
        mc_results.append(last_run(gp, temp, chunk=chunk))
        timer("last_run")
    return blur_results, mc_results


def pdf_marginal_knn(gp: GraphPoints, neighbors, jitter: bool = False,
                     chunk: int = KNN_CHUNK):
    """Per-point scatter normalizer over the k-NN graph; jitter
    restricts to same-cluster neighbors (requires gp.groupIdx)."""
    nb = _i64(neighbors, gp)
    n = nb.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=gp.device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        out[c0:c1] = _pdf_marginal_knn_block(gp, _arange(c0, c1, gp),
                                             nb[c0:c1], jitter)
    return out


def scatter_radiance_knn(gp: GraphPoints, temp, neighbors, marginal,
                         jitter: bool = False, weights=None,
                         chunk: int = KNN_CHUNK):
    """Scatter-form aggregation pass over the k-NN graph
    (allGPUScatterRadiance & variants): the CUDA atomicAdd deposits
    become `index_add_` over the flattened neighbor lists."""
    nb = _i64(neighbors, gp)
    n = nb.shape[0]
    temp = _f32(temp, gp)
    marg = _f32(marginal, gp)
    if weights is not None:
        wsum, maxd = (_f32(w, gp) for w in weights)
    out = torch.zeros((n, 3), dtype=torch.float32, device=gp.device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        contrib = _scatter_contrib_block(
            gp, temp, _arange(c0, c1, gp), nb[c0:c1], marg[c0:c1], jitter,
            None if weights is None else wsum[c0:c1],
            None if weights is None else maxd[c0:c1])
        out.index_add_(0, nb[c0:c1].reshape(-1), contrib.reshape(-1, 3))
    return _finite(out)


def weight_norms_knn(gp: GraphPoints, neighbors, chunk: int = KNN_CHUNK):
    """(weightsum, max_dist, weighted_marginal) per point for the
    weighted scatter."""
    nb = _i64(neighbors, gp)
    n = nb.shape[0]
    outs = [torch.empty(n, dtype=torch.float32, device=gp.device)
            for _ in range(3)]
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        for o, v in zip(outs, _weight_norm_block(gp, _arange(c0, c1, gp),
                                                 nb[c0:c1])):
            o[c0:c1] = v
    return tuple(outs)


def iterate_knn_scatter(gp: GraphPoints, neighbors, iterations: int,
                        direct=None, jitter_last: bool = False,
                        weighted: bool = False, chunk: int = KNN_CHUNK):
    """Scatter-family iteration driver
    (computeScatterAllOnGPUWithDirectOpt, pbsdf.cu:2543-2607):
    plain scatter iterations with temp <- direct + indirect, then a
    final lastRun that is either the point's own-BSDF conversion or
    the jittered same-cluster scatter (lastRunJitter + the jittered
    marginal).  weighted applies the distance-falloff deposits
    (pbsdf.cu:1458).  Returns (blur_final, mc_final) tensors."""
    nb = _i64(neighbors, gp)
    if weighted:
        ws, md, marginal = weight_norms_knn(gp, nb, chunk=chunk)
        weights = (ws, md)
    else:
        marginal = pdf_marginal_knn(gp, nb, jitter=False, chunk=chunk)
        weights = None
    direct = gp.eLd if direct is None else _f32(direct, gp)
    temp = gp.eLi.clone()
    rad = None
    for it in range(iterations):
        rad = scatter_radiance_knn(gp, temp, nb, marginal,
                                   weights=weights, chunk=chunk)
        temp = direct + rad
    if jitter_last:
        marg_j = pdf_marginal_knn(gp, nb, jitter=True, chunk=chunk)
        mc = scatter_radiance_knn(gp, temp, nb, marg_j, jitter=True,
                                  chunk=chunk)
    else:
        mc = last_run(gp, temp)
    return rad, mc


def last_run(gp: GraphPoints, temp, chunk: int = LAST_RUN_CHUNK):
    """Final MC conversion through the point's own BSDF/pdf
    (lastRun, pbsdf.cu:1497-1526)."""
    n = gp.nidx.shape[0]
    temp = _f32(temp, gp)
    out = torch.empty((n, 3), dtype=torch.float32, device=gp.device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        out[c0:c1] = _last_run_block(gp, temp, _arange(c0, c1, gp))
    return _finite(out)


# ---------------------------------------------------------------------------
# Cluster mode
# ---------------------------------------------------------------------------

def _cluster_tables(gp, members, sizes):
    """The padded member table and sizes on the device, and each lane's
    target row: its member, or row n (a scratch row) past the size."""
    mem = _i64(members, gp)
    siz = _i64(sizes, gp)
    tgt = torch.where(_lanes_valid(mem, siz), mem, gp.nidx.shape[0])
    return mem, siz, tgt


def _per_member(gp, mem, siz, tgt, chunk, block, width=None):
    """Run block(mem_c, siz_c) -> (m, pad[, width]) over the clusters in
    chunks and put each valid lane's value at its member's row."""
    n = gp.nidx.shape[0]
    shape = (n + 1,) if width is None else (n + 1, width)
    out = torch.zeros(shape, dtype=torch.float32, device=gp.device)
    for b0 in range(0, mem.shape[0], chunk):
        b1 = min(b0 + chunk, mem.shape[0])
        vals = block(mem[b0:b1], siz[b0:b1])
        out[tgt[b0:b1].reshape(-1)] = vals.reshape((-1,) + shape[1:])
    return out[:n]


def marginal_cluster(gp: GraphPoints, members, sizes, cluster_id,
                     chunk: int = CLUSTER_CHUNK):
    """Per-point marginal (allGPUClusterPdfMarginal, pbsdf.cu:1239)."""
    mem, siz, tgt = _cluster_tables(gp, members, sizes)
    return _per_member(gp, mem, siz, tgt, chunk,
                       lambda m, s: _marginal_block(gp, m, s))


def direct_cluster(gp: GraphPoints, lps, members, sizes,
                   chunk: int = CLUSTER_CHUNK, include_emitter: bool = True):
    """ClusterDirect (pbsdf.cu:2400-2430): direct-light MIS
    re-aggregation (+ addEmitterToDirectLight when include_emitter).

    NOTE: the iteration uses the WITHOUT-emitter variant as the temp
    source — the dumps deliver next-vertex emission through the MIS
    em-hit half of L_bsdfsample, so adding L_em into temp as well would
    double-count it (deviation from the literal kernel order, which
    assumes the external pathrenderer's eLd/eLi conventions)."""
    mem, siz, tgt = _cluster_tables(gp, members, sizes)
    ld = _f32(lps["L_directsample"], gp)
    lb = _f32(lps["L_bsdfsample"], gp)
    lightpdf = _f32(lps["lightpdf"], gp)
    out = _per_member(
        gp, mem, siz, tgt, chunk,
        lambda m, s: _direct_block(gp, ld, lb, lightpdf, m, s), width=3)
    if include_emitter:
        out = out + _f32(lps["L_em"], gp)
    return _finite(out)


def iterate_cluster(gp: GraphPoints, lps, members, sizes, cluster_id,
                    iterations: int, chunk: int = CLUSTER_CHUNK,
                    mode: str = "opt", timer=_no_timer):
    """Cluster-mode iteration drivers; returns
    (blur_results, mc_results, direct) matching ResultSpace, tensors.

    mode selects the reference driver (src/cluster.cpp:215-226):
      "opt" — ClusterIterations3 (ClusterScatterWithDirectOptNR,
              shadingPoint.h:600): temp <- blurred_direct + indirect,
              NO per-iteration recording; one lastRun at the end.
      "n"   — ClusterIterations (ClusterScatter2, shadingPoint.h:555):
              matrix elements PRECOMPUTED once
              (precomputedMatrixElemtns) when they fit in
              ELEMENTS_BUDGET_BYTES, else re-evaluated as in "t";
              temp <- indirect + stored per-point eLd, blur+mc
              recorded EVERY iteration.
      "t"   — computeClusterScatterAllOnGPURecord (ClusterScatter,
              shadingPoint.h:535): same update rule as "n" but the
              BSDF re-evaluation happens inside every iteration;
              records every iteration.
    All three apply the per-cluster energy clamp (clampCluster/
    computeRatio/updateComputeCluster, pbsdf.cu:2127-2183).
    timer(stage) is called as each stage ends ("direct", "marginal",
    "elements", "iteration i", "last_run").
    """
    if mode not in ("opt", "n", "t"):
        raise ValueError(f"iterate_cluster: unknown mode '{mode}'")
    n = gp.nidx.shape[0]
    direct = direct_cluster(gp, lps, members, sizes, chunk=chunk,
                            include_emitter=False)
    timer("direct")
    marginal = marginal_cluster(gp, members, sizes, cluster_id, chunk=chunk)
    timer("marginal")
    mem, siz, tgt = _cluster_tables(gp, members, sizes)
    c, pad = mem.shape

    elements = None
    if mode == "n" and c * pad * pad * 3 * 4 <= ELEMENTS_BUDGET_BYTES:
        elements = [
            _elements_block(gp, marginal, mem[b0:b0 + chunk],
                            siz[b0:b0 + chunk])
            for b0 in range(0, c, chunk)]
        timer("elements")

    def mx_pass(temp):
        if elements is None:
            block = lambda m, s: _mx_block(gp, temp, marginal, m, s)
        else:
            # _per_member walks the chunks in order, as they were built
            blocks = iter(elements)
            block = lambda m, s: _mx_from_elements_block(
                next(blocks), temp, m)
        return _finite(_per_member(gp, mem, siz, tgt, chunk, block, width=3))

    cid = _i64(cluster_id, gp)
    ncl = int(torch.unique(cid).numel())
    feeding = gp.nidx > 0
    nxt = torch.clamp_max(_arange(1, n + 1, gp), n - 1)

    def energy_ratio(rad, temp):
        """Per-cluster energy clamp (clampCluster/computeRatio/
        updateComputeCluster, pbsdf.cu:2127-2183): if a cluster emits
        more than it received, rescale its output per channel."""
        inn = torch.zeros((ncl, 3), dtype=torch.float64, device=gp.device)
        outn = torch.zeros((ncl, 3), dtype=torch.float64, device=gp.device)
        inn.index_add_(0, cid, torch.where(feeding[:, None], temp[nxt],
                                           0.0).double())
        outn.index_add_(0, cid, rad.double())
        ratio = torch.where(inn < outn, inn / torch.clamp_min(outn, 1e-20),
                            1.0)
        return (rad.double() * ratio[cid]).float()

    temp = gp.eLi.clone()
    blur_results, mc_results = [], []
    for it in range(iterations):
        rad = energy_ratio(mx_pass(temp), temp)
        timer(f"iteration {it + 1}")
        if mode == "opt":
            # temp <- blurred direct + indirect (updateWithOptDirect);
            # record only after the final iteration (the NR driver)
            temp = rad + direct
            if it == iterations - 1:
                blur_results.append(rad)
                mc_results.append(last_run(gp, temp))
                timer("last_run")
        else:
            # temp <- stored per-point direct + indirect
            # (updateRadiance j>0); record every iteration
            blur_results.append(rad)
            temp = rad + gp.eLd
            mc_results.append(last_run(gp, temp))
            timer("last_run")
    # display variant includes each vertex's own emission
    return blur_results, mc_results, direct + _f32(lps["L_em"], gp)
