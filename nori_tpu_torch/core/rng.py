"""Deterministic counter-based random streams.

Port of `nori_tpu/core/rng.py`: every (lane, decision) pair maps to an
independent uniform through a hash of (seed, lane_id, stream_id), so a
sample's value does not depend on lane scheduling or batching.

The hash is the wrapping uint32 PCG hash.  PyTorch's uint32 lacks `+`
and `>>` on the CPU, so the arithmetic runs in int64 holding values in
[0, 2^32) and masks after every add and multiply: the products stay
below 2^62, so no step overflows int64 and every result equals the
uint32 one bit for bit.  Arguments may be Python ints or integer
tensors holding uint32 values.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    dev = like.device if like is not None else None
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=dev)


def _pcg(x: torch.Tensor) -> torch.Tensor:
    """PCG output hash (Jarzynski & Olano, "Hash Functions for GPU
    Rendering", JCGT 2020) on int64 tensors holding uint32 values."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def hash_combine(*ints) -> torch.Tensor:
    """Chain the PCG hash over the inputs; returns int64 tensors
    holding the uint32 hash."""
    like = next((v for v in ints if isinstance(v, torch.Tensor)), None)
    acc = _u32(0x9E3779B9, like)
    for v in ints:
        acc = _pcg((acc + _u32(v, like)) & _M32)
    return _pcg(acc)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(seed, lane, stream) -> torch.Tensor:
    """U[0,1) for each (lane, stream); arguments broadcast."""
    return uniform_from_bits(hash_combine(seed, lane, stream))


def uniform2(seed, lane, stream) -> torch.Tensor:
    """A pair of independent uniforms (2D sample); returns (..., 2).

    Stream ids are offset into a reserved range so a `uniform(s)` call
    never collides with a `uniform2(s')` call for small ids (< 2**16).
    """
    like = lane if isinstance(lane, torch.Tensor) else None
    s = _u32(stream, like)
    u1 = uniform(seed, lane, (s + 0x10000) & _M32)
    u2 = uniform(seed, lane, (s + 0x20000) & _M32)
    return torch.stack([u1, u2], dim=-1)
