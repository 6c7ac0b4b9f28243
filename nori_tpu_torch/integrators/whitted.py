"""Whitted-style direct illumination integrator.

Port of `nori_tpu/integrators/whitted.py`; semantics pinned by
scenes/pa4 (cbox-whitted.xml, cbox-distributed.xml, motto scenes):
Li = Le(x) + area-light sampling at diffuse surfaces; specular
(mirror/dielectric) surfaces recurse with survival probability 0.95
and weight 1/0.95.  Wavefront form: a depth loop over the batch where
diffuse lanes terminate after their light sample and only discrete
lanes continue.  The loop (integrators.base.run_depths) ends when no
lane is alive, which the host reads before each depth past the first.
"""

from __future__ import annotations

import torch

from nori_tpu_torch.accel.traverse import intersect, occluded
from nori_tpu_torch.bsdf import E_DISCRETE, eval_bsdf, sample_bsdf
from nori_tpu_torch.core.vecmath import (
    EPSILON, dot, make_frame, to_local, to_world)
from nori_tpu_torch.integrators.base import (
    DepthLoop, Integrator, lane_uniform, lane_uniform2, mesh_params,
    path_state, sample_emitter_point_fast, shadow_ray_args)
from nori_tpu_torch.interaction import fill_interaction_fast
from nori_tpu_torch.registry import register_class

MAX_DEPTH = 24
SURVIVAL = 0.95


def _body(sd, st, depth: int, seed, lanes) -> dict:
    """One depth over the batch: the live lanes' closest hits, emitted
    radiance, one area-light sample and the specular continuation."""
    o, d, mint, maxt = st["o"], st["d"], st["mint"], st["maxt"]
    L, beta, alive = st["L"], st["beta"], st["alive"]
    n, dev = o.shape[0], o.device
    rays = st["rays"] + alive.sum()
    hit = intersect(sd, o, d, mint, maxt)
    its = fill_interaction_fast(sd, hit, o, d)
    live_hit = alive & its.valid
    params, mesh_le = mesh_params(sd, its)
    # emitted radiance at the visited vertex (front side)
    front = dot(its.sh_n, its.wi_world) > 0.0
    le = torch.where((its.valid & front)[:, None], mesh_le, 0.0)
    L = L + torch.where(live_hit[:, None], beta * le, 0.0)

    frame = make_frame(its.sh_n)
    wi_local = to_local(frame, its.wi_world)

    # --- area-light sampling (diffuse-class lanes only; discrete BSDFs
    # evaluate to 0 so masking is implicit)
    u_pick = lane_uniform(seed, lanes, 8 * depth + 1)
    u2 = lane_uniform2(seed, lanes, 8 * depth + 2)
    y, n_y, le_y, pdf_area = sample_emitter_point_fast(sd, u_pick, u2)
    wo_w, dist, smint, smaxt = shadow_ray_args(its.p, y)
    cos_y = dot(n_y, -wo_w)
    wo_local = to_local(frame, wo_w)
    f = eval_bsdf(params, wi_local, wo_local)
    g_over_p = torch.where(
        (cos_y > 0.0) & (pdf_area > 0.0),
        wo_local[..., 2] * cos_y
        / torch.clamp_min(dist * dist * pdf_area, 1e-20),
        0.0,
    )
    # cull provably-zero shadow queries (dead/specular lanes, back-facing
    # samples): their contribution is 0 whatever the visibility
    ok = (live_hit & (g_over_p > 0.0)
          & (torch.amax(beta * f, dim=-1) > 0.0))
    smaxt = torch.where(ok, smaxt, -1.0)
    rays = rays + ok.sum()
    vis = ~occluded(sd, its.p, wo_w, smint, smaxt)
    contrib = beta * f * le_y * (g_over_p * vis)[:, None]
    L = L + torch.where(live_hit[:, None], contrib, 0.0)

    # --- specular continuation with RR prob 0.95
    u_lobe = lane_uniform(seed, lanes, 8 * depth + 3)
    u_dir = lane_uniform2(seed, lanes, 8 * depth + 4)
    s = sample_bsdf(params, wi_local, u_lobe, u_dir)
    u_rr = lane_uniform(seed, lanes, 8 * depth + 5)
    cont = live_hit & (s.measure == E_DISCRETE) & (u_rr < SURVIVAL)
    beta = torch.where(cont[:, None], beta * s.weight / SURVIVAL, beta)
    return {"o": its.p, "d": to_world(frame, s.wo),
            "mint": torch.full((n,), EPSILON, dtype=torch.float32,
                               device=dev),
            "maxt": torch.full((n,), 1e30, dtype=torch.float32, device=dev),
            "L": L, "beta": beta, "alive": cont, "rays": rays}


@register_class("whitted")
class WhittedIntegrator(Integrator):
    def __init__(self, props):
        pass

    def make_depth(self, scene, device):
        return DepthLoop(_body, MAX_DEPTH, path_state)

    def to_string(self):
        return "WhittedIntegrator[]"
