"""Integrator base class + shared light-transport helpers.

Port of `nori_tpu/integrators/base.py` (the parts the integrators
use).
"""

from __future__ import annotations

import torch

from nori_tpu_torch import registry
from nori_tpu_torch.bsdf import BSDFParams
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.core.vecmath import EPSILON, normalize
from nori_tpu_torch.core.dpdf import sample_discrete
from nori_tpu_torch.core import rng


class Integrator(NoriObject):
    class_kind = registry.INTEGRATOR

    def preprocess(self, scene):
        """Hook matching Integrator::preprocess (integrator.h:42)."""

    def make_li(self, scene):
        """li(sd, o, d, mint, maxt, seed, lanes) -> ((N, 3) radiance,
        {"rays": count tensor}) over a batch of N rays; lanes are the
        global sample ids keying the RNG."""
        raise NotImplementedError


def sample_emitter_point_fast(scene, u_pick, u2):
    """Uniform-area sample over all emissive triangles, read from the
    packed (E, 24) emissive table (SceneData.em_attr).

    Returns (y, n_y, Le, pdf_area): position, shading normal, radiance
    and the (constant) area density 1/totalEmissiveArea.
    """
    idx, _ = sample_discrete(scene.em_cdf, u_pick)
    a = scene.em_attr[idx]                        # (N, 24)
    su = torch.sqrt(torch.clamp_min(u2[..., 0], 0.0))
    b1 = 1.0 - su
    b2 = u2[..., 1] * su
    b0 = 1.0 - b1 - b2
    y = a[:, 0:3] + b1[..., None] * a[:, 3:6] + b2[..., None] * a[:, 6:9]
    n_y = normalize(
        b0[..., None] * a[:, 9:12]
        + b1[..., None] * a[:, 12:15]
        + b2[..., None] * a[:, 15:18],
        eps=1e-24,
    )
    le = a[:, 18:21]
    pdf_area = torch.where(scene.em_area > 0.0, 1.0 / scene.em_area, 0.0)
    return y, n_y, le, pdf_area


def mesh_params(sd, its):
    """(BSDFParams, emitted radiance (N, 3)) of each hit's mesh, from one
    gather of the packed per-mesh rows (SceneData.mesh_attr)."""
    am = sd.mesh_attr[its.mesh.long()]
    params = BSDFParams(
        type=am[:, 0].contiguous().view(torch.int32),
        albedo=am[:, 1:4], alpha=am[:, 4],
        int_ior=am[:, 5], ext_ior=am[:, 6], ks=am[:, 7],
    )
    return params, am[:, 8:11]


def shadow_ray_args(p, y):
    """Ray setup for a visibility test between surface points p and y."""
    dvec = y - p
    dist = torch.sqrt(torch.clamp_min(torch.sum(dvec * dvec, dim=-1), 1e-24))
    wo = dvec / dist[..., None]
    mint = torch.full(dist.shape, EPSILON, dtype=torch.float32,
                      device=dist.device)
    maxt = dist * (1.0 - 1e-4)
    return wo, dist, mint, maxt


def lane_uniform(seed, lanes, stream):
    return rng.uniform(seed, lanes, stream)


def lane_uniform2(seed, lanes, stream):
    return rng.uniform2(seed, lanes, stream)
