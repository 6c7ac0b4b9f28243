"""Film: filtered sample accumulation (image reconstruction).

Port of `nori_tpu/film.py`, which replaces ImageBlock
(include/nori/block.h, src/block.cpp:74-114).  The reference splats
each sample into a mutex-protected Color4f array using tabulated
separable filter weights; here a batched scatter-add
(`Tensor.index_add_`) adds value*wx*wy into a bordered
(H+2B, W+2B, 4) RGBA-weight array for each of the K*K filter taps.
On a CUDA device the adds are atomic, so their order, and the last
bits of a sum, may change from run to run.

Invalid radiance samples (NaN/negative) are dropped and counted, the
functional version of the warning in ImageBlock::put
(src/block.cpp:75-79).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FilmSpec:
    """Static film configuration."""

    width: int
    height: int
    border: int
    footprint: int  # K: number of pixels covered per axis
    radius: float

    @staticmethod
    def for_filter(width: int, height: int, rfilter) -> "FilmSpec":
        r = float(rfilter.radius)
        border = int(math.ceil(r - 0.5))
        footprint = int(math.floor(2.0 * r)) + 1
        return FilmSpec(width, height, border, footprint, r)

    @property
    def padded_shape(self):
        return (self.height + 2 * self.border, self.width + 2 * self.border, 4)


def new_accumulator(spec: FilmSpec, device="cpu") -> torch.Tensor:
    return torch.zeros(spec.padded_shape, dtype=torch.float32, device=device)


def is_valid(c: torch.Tensor) -> torch.Tensor:
    """Per-color validity: finite and non-negative (color.h isValid)."""
    return torch.all(torch.isfinite(c) & (c >= 0.0), dim=-1)


def splat(spec: FilmSpec, rfilter, accum, positions, values):
    """Scatter-add filtered samples into the accumulator.

    accum: (H+2B, W+2B, 4); positions: (N, 2) raw continuous pixel
    coords; values: (N, 3) radiance.  Returns (new_accum, n_dropped).

    Geometry matches ImageBlock::put (src/block.cpp:81-103): the sample
    position is shifted by -0.5 (pixel-center convention) and +border,
    the affected pixel window is [ceil(p - r), floor(p + r)], and the
    weight is the separable filter evaluated at the pixel-to-sample
    distance (evaluated exactly, not via the reference's 32-entry
    lookup table).
    """
    valid = is_valid(values) & torch.all(torch.isfinite(positions), dim=-1)
    n_dropped = torch.sum(~valid)
    v = torch.where(valid[:, None], values, 0.0)

    p = positions - 0.5 + spec.border
    base_x = torch.ceil(p[:, 0] - spec.radius).to(torch.int64)
    base_y = torch.ceil(p[:, 1] - spec.radius).to(torch.int64)

    K = spec.footprint
    offs = torch.arange(K, dtype=torch.int64, device=accum.device)
    tx = base_x[:, None] + offs[None, :]
    ty = base_y[:, None] + offs[None, :]
    wx = rfilter.eval(tx.to(torch.float32) - p[:, 0:1])
    wy = rfilter.eval(ty.to(torch.float32) - p[:, 1:2])
    # zero weight outside the exact window [ceil(p-r), floor(p+r)]
    wx = torch.where(tx.to(torch.float32) <= p[:, 0:1] + spec.radius, wx, 0.0)
    wy = torch.where(ty.to(torch.float32) <= p[:, 1:2] + spec.radius, wy, 0.0)
    wx = torch.where(valid[:, None], wx, 0.0)

    hp, wp, _ = spec.padded_shape
    rgba = torch.cat([v, torch.ones_like(v[:, :1])], dim=-1)  # (N, 4)
    # one spare pixel past the film takes the dropped taps
    flat = torch.cat([accum.reshape(-1), accum.new_zeros(4)])
    ch = torch.arange(4, dtype=torch.int64, device=accum.device)
    for ky in range(K):
        yy = ty[:, ky]
        in_y = (yy >= 0) & (yy < hp)
        for kx in range(K):
            xx = tx[:, kx]
            w2 = wx[:, kx] * wy[:, ky]
            ok = in_y & (xx >= 0) & (xx < wp) & (w2 != 0.0)
            base = torch.where(ok, (yy * wp + xx) * 4, hp * wp * 4)
            idx = (base[:, None] + ch[None, :]).reshape(-1)
            flat.index_add_(0, idx, (rgba * w2[:, None]).reshape(-1))
    return flat[:hp * wp * 4].reshape(accum.shape), n_dropped


def to_bitmap(spec: FilmSpec, accum) -> torch.Tensor:
    """Normalize by accumulated filter weight -> (H, W, 3) image
    (ImageBlock::toBitmap / Color4f::divideByFilterWeight)."""
    B = spec.border
    inner = accum[B:B + spec.height, B:B + spec.width]
    w = inner[..., 3:4]
    return torch.where(w > 0.0, inner[..., :3] / torch.clamp_min(w, 1e-20),
                       0.0)


def merge(accum_a, accum_b):
    """Merge partial accumulators (replaces the mutex-locked
    ImageBlock::put(block) tile merge, src/block.cpp:105-114)."""
    return accum_a + accum_b


# ---------------------------------------------------------------------------
# Host-side tile schedule (spiral order, matching BlockGenerator,
# src/block.cpp:121-164), kept for incremental rendering and API parity.
# ---------------------------------------------------------------------------

NORI_BLOCK_SIZE = 32  # block.h:29


def spiral_blocks(width: int, height: int, block_size: int = NORI_BLOCK_SIZE):
    """Yield (x0, y0, w, h) tiles in center-outward spiral order."""
    nx = (width + block_size - 1) // block_size
    ny = (height + block_size - 1) // block_size
    bx, by = nx // 2, ny // 2
    direction = 0  # 0=right, 1=down, 2=left, 3=up
    steps_left = 1
    num_steps = 1
    emitted = 0
    total = nx * ny
    while emitted < total:
        if 0 <= bx < nx and 0 <= by < ny:
            x0, y0 = bx * block_size, by * block_size
            yield (
                x0, y0,
                min(block_size, width - x0),
                min(block_size, height - y0),
            )
            emitted += 1
        if emitted == total:
            break
        if direction == 0:
            bx += 1
        elif direction == 1:
            by += 1
        elif direction == 2:
            bx -= 1
        else:
            by -= 1
        steps_left -= 1
        if steps_left == 0:
            direction = (direction + 1) % 4
            if direction in (0, 2):
                num_steps += 1
            steps_left = num_steps
