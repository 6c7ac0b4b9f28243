"""Linear-RGB colour helpers.

From `nori_tpu/core/color.py` (reference include/nori/color.h,
src/common.cpp:178-220): the tensor helpers the port calls and the
host-side (numpy) sRGB curve used by image output.
"""

from __future__ import annotations

import numpy as np
import torch


def luminance(c: torch.Tensor) -> torch.Tensor:
    """ITU-R Rec. BT.709 luminance (src/common.cpp:218-220)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def is_valid(c: torch.Tensor) -> torch.Tensor:
    """Per-colour validity: finite and non-negative (color.h isValid)."""
    return torch.all(torch.isfinite(c) & (c >= 0.0), dim=-1)


def np_to_srgb(c: np.ndarray) -> np.ndarray:
    """Linear -> sRGB on the host."""
    return np.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * np.power(np.maximum(c, 1e-12), 1.0 / 2.4) - 0.055,
    )
