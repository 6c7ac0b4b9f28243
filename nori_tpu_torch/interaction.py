"""Surface interaction records.

Port of the hot-path fill of `nori_tpu/interaction.py` (reference
Intersection, include/nori/mesh.h:35-64): barycentric position and uv
interpolation, geometric normal, interpolated shading normal, over
ray lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nori_tpu_torch.accel.traverse import Hit
from nori_tpu_torch.core.vecmath import normalize


class Interaction(NamedTuple):
    valid: torch.Tensor   # (N,) bool
    t: torch.Tensor       # (N,)
    p: torch.Tensor       # (N, 3) hit position (barycentric-accurate)
    uv: torch.Tensor      # (N, 2) texture coords
    geo_n: torch.Tensor   # (N, 3) geometric normal
    sh_n: torch.Tensor    # (N, 3) shading normal
    mesh: torch.Tensor    # (N,) int32 mesh id
    tri: torch.Tensor     # (N,) int32 triangle id
    wi_world: torch.Tensor  # (N, 3) direction back toward the ray origin


def fill_interaction_fast(sd, hit: Hit, o, d) -> Interaction:
    """One-gather interaction fill from the packed (T, 28) attribute
    table (SceneData.tri_attr).  The hit point is rebuilt from the
    winning triangle as v0 + u e1 + v e2 rather than o + t d, so it
    does not depend on the sweep's t rounding."""
    tri = torch.clamp_min(hit.tri, 0)
    a = sd.tri_attr[tri.long()]                   # (N, 28)
    v0r, e1r, e2r = a[:, 19:22], a[:, 22:25], a[:, 25:28]
    u, v = hit.u, hit.v
    b0 = 1.0 - u - v
    p = v0r + u[:, None] * e1r + v[:, None] * e2r
    p = torch.where(hit.valid[:, None], p, o + hit.t[:, None] * d)
    geo_n = a[:, 0:3]
    sh_n = normalize(
        b0[:, None] * a[:, 3:6]
        + u[:, None] * a[:, 6:9]
        + v[:, None] * a[:, 9:12],
        eps=1e-24,
    )
    uv = (
        b0[:, None] * a[:, 12:14]
        + u[:, None] * a[:, 14:16]
        + v[:, None] * a[:, 16:18]
    )
    mesh = a[:, 18].contiguous().view(torch.int32)
    return Interaction(
        valid=hit.valid, t=hit.t, p=p, uv=uv, geo_n=geo_n, sh_n=sh_n,
        mesh=mesh, tri=tri, wi_world=-d,
    )
