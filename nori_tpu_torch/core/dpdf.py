"""Discrete probability distribution sampling.

Port of `nori_tpu/core/dpdf.py` (reference include/nori/dpdf.h:33-196):
sampling is a vectorized inverse-CDF lookup over a CDF that
`Scene.compile` builds on the host.
"""

from __future__ import annotations

import torch


def sample_discrete(cdf: torch.Tensor, u: torch.Tensor):
    """Vectorized inverse-CDF sample.

    cdf: (n+1,) monotone with cdf[0]=0, cdf[-1]=1; u: (...,) uniforms.
    Returns (index, reused uniform) like dpdf.h `sampleReuse`: the
    remapped uniform is (u - cdf[i]) / (cdf[i+1] - cdf[i]).
    """
    n = cdf.shape[0]
    if n <= 2048:
        # compare-all, the JAX package's formulation for short CDFs
        idx = torch.sum(u[..., None] >= cdf[1:n - 1], dim=-1)
    else:
        idx = torch.clamp(
            torch.searchsorted(cdf, u, right=True) - 1, 0, n - 2)
    lo = cdf[idx]
    hi = cdf[idx + 1]
    reuse = (u - lo) / torch.clamp_min(hi - lo, 1e-20)
    return idx, reuse
