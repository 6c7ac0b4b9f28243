"""Batch orchestration: run merging + RMSE protocol.

Copy of `nori_tpu/pathgraph/merge.py` (numpy) with its imports
rewritten.

Replaces python/utils.py (the fork's evaluation tooling): merge
independently rendered per-run EXRs (tungsten `hdrmanip --merge`
equivalent is a plain mean of linear HDR images) and compute RMSE
against a high-spp reference (`hdrmanip --rmse` equivalent), including
the equal-RMSE spp search the refDict tables encode
(python/utils.py:153-232).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from nori_tpu_torch.bitmap import read_exr, write_exr


def merge_exrs(paths, out_path: str | None = None) -> np.ndarray:
    """Average linear-HDR EXRs (equal-weight sample-batch merge)."""
    imgs = [read_exr(p) for p in paths]
    ref = imgs[0].shape
    for p, im in zip(paths, imgs):
        if im.shape != ref:
            raise ValueError(f"size mismatch: {p} {im.shape} vs {ref}")
    out = np.mean(imgs, axis=0).astype(np.float32)
    if out_path:
        write_exr(out_path, out)
    return out


def merge_glob(pattern: str, out_path: str | None = None) -> np.ndarray:
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(pattern)
    return merge_exrs(paths, out_path)


def rmse(img, ref, clamp: float | None = None) -> float:
    """Root-mean-square error over all channels (hdrmanip --rmse)."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    if clamp is not None:
        a = np.minimum(a, clamp)
        b = np.minimum(b, clamp)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_mse(img, ref, eps: float = 1e-2) -> float:
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def equal_rmse_spp(render_fn, ref, target_rmse: float,
                   spp_candidates=(1, 2, 4, 8, 16, 32, 64, 128, 256)):
    """Find the lowest spp whose render RMSE <= target (the per-scene
    'pt spp at parity' observable, python/utils.py:168-181)."""
    for spp in spp_candidates:
        img, _ = render_fn(spp)
        e = rmse(img, ref)
        if e <= target_rmse:
            return spp, e
    return None, None
