"""Linear-RGB colour helpers used by image output.

Host-side (numpy) part of `nori_tpu/core/color.py`
(reference src/common.cpp:178-192).
"""

from __future__ import annotations

import numpy as np


def np_to_srgb(c: np.ndarray) -> np.ndarray:
    """Linear -> sRGB on the host."""
    return np.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * np.power(np.maximum(c, 1e-12), 1.0 / 2.4) - 0.055,
    )
