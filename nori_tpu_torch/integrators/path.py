"""Path-tracer plugins: path_mats / path_ems / path_mis / path.

Port of `nori_tpu/integrators/path.py`.  `path_vertex` is one bounce
of the estimator.  Two drivers step it: the persistent wavefront
(nori_tpu_torch.wavefront), through which `render_to_files` renders the
path family, and the batched depth loop (make_path_depth), which
`render.render` drives as the JAX package's `render` does.  `mode`
selects the estimator:
  * path_mats — BSDF sampling only; emitter contributions on hit.
  * path_ems  — next-event estimation at every solid-angle vertex;
    emitter hits counted only after discrete bounces / primary rays.
  * path_mis  — both strategies, balance-heuristic weighted.
  * path      — alias of path_mis.

Russian roulette starts at depth RR_START with continuation
probability min(RR_MAX, max(throughput)).
"""

from __future__ import annotations

import torch

from nori_tpu_torch.accel.traverse import intersect, occluded
from nori_tpu_torch.bsdf import E_DISCRETE, eval_bsdf, pdf_bsdf, sample_bsdf
from nori_tpu_torch.core.vecmath import (
    EPSILON, dot, make_frame, to_local, to_world)
from nori_tpu_torch.integrators.base import (
    DepthLoop, Integrator, lane_uniform, lane_uniform2, mesh_params,
    path_state, sample_emitter_point_fast, shadow_ray_args)
from nori_tpu_torch.interaction import fill_interaction_fast
from nori_tpu_torch.registry import register_class

MAX_DEPTH = 48
RR_START = 3
RR_MAX = 0.95

MATS, EMS, MIS = 0, 1, 2


def path_vertex(sd, mode: int, o, d, mint, maxt, live, depth, beta, L,
                spec, prev_pdf, seed, q, hit=None,
                defer_shadow: bool = False):
    """One vertex of the path estimator over a batch of lanes
    (path.py:60-182): closest hit, emitter hit weighted for `mode`,
    next-event estimation, Russian roulette and BSDF sampling.

    live masks the lanes that carry a path; depth, an (N,) int tensor,
    keys the RNG streams 8 * depth + k of sample ids q and starts the
    roulette at RR_START; spec (the previous bounce was discrete, or
    this is a primary ray) and prev_pdf describe the previous bounce.
    hit, when given, is the closest hit of these rays, traced earlier
    (the merged wavefront step carries it); else the vertex traces it.
    Returns (its, frame, BSDF sample, L, beta, alive, shadow rays,
    deferred).  With defer_shadow (NEE modes) the NEE visibility is left
    to the caller: L leaves out the NEE term and deferred is (pending
    contribution (N, 3), shadow-ray args (o, d, mint, maxt)), the
    contribution to add where the shadow ray is unoccluded; otherwise
    deferred is None."""
    n, dev = o.shape[0], o.device
    if hit is None:
        hit = intersect(sd, o, d, mint, maxt)
    its = fill_interaction_fast(sd, hit, o, d)
    live_hit = live & its.valid
    params, mesh_le = mesh_params(sd, its)

    # ---- emitter hit ------------------------------------------------
    front = dot(its.sh_n, its.wi_world) > 0.0
    le = torch.where((its.valid & front)[:, None], mesh_le, 0.0)
    if mode == MATS:
        w_em = torch.ones((n,), dtype=torch.float32, device=dev)
    elif mode == EMS:
        w_em = spec.to(torch.float32)
    else:  # MIS balance heuristic vs the NEE strategy
        cos_y = dot(its.sh_n, its.wi_world)
        p_light_sa = torch.where(
            (sd.em_area > 0.0) & (cos_y > 1e-8),
            (its.t * its.t) / (sd.em_area * torch.clamp_min(cos_y, 1e-8)),
            0.0,
        )
        w_em = torch.where(
            spec, 1.0,
            prev_pdf / torch.clamp_min(prev_pdf + p_light_sa, 1e-20))
    L = L + torch.where(live_hit[:, None], beta * le * w_em[:, None], 0.0)

    frame = make_frame(its.sh_n)
    wi_local = to_local(frame, its.wi_world)
    du = depth.to(torch.int64) * 8
    n_shadow = 0
    deferred = None

    # ---- next-event estimation --------------------------------------
    if mode in (EMS, MIS):
        u_pick = lane_uniform(seed, q, du + 1)
        u2 = lane_uniform2(seed, q, du + 2)
        y, n_y, le_y, pdf_area = sample_emitter_point_fast(sd, u_pick, u2)
        wo_w, dist, smint, smaxt = shadow_ray_args(its.p, y)
        cos_l = dot(n_y, -wo_w)
        wo_local = to_local(frame, wo_w)
        f = eval_bsdf(params, wi_local, wo_local)
        p_light_sa = torch.where(
            cos_l > 1e-8,
            pdf_area * dist * dist / torch.clamp_min(cos_l, 1e-8),
            0.0,
        )
        # a lane whose contribution is already zero needs no visibility
        # answer: cull it from the shadow sweep
        ok = ((cos_l > 1e-8) & (p_light_sa > 0.0) & live_hit
              & (torch.amax(beta * f, dim=-1) > 0.0))
        smaxt = torch.where(ok, smaxt, -1.0)
        n_shadow = ok.sum()
        if mode == MIS:
            p_b = pdf_bsdf(params, wi_local, wo_local)
            w_l = p_light_sa / torch.clamp_min(p_light_sa + p_b, 1e-20)
        else:
            w_l = torch.ones((n,), dtype=torch.float32, device=dev)
        contrib = (
            beta * f * le_y
            * (wo_local[..., 2] / torch.clamp_min(p_light_sa, 1e-20)
               * w_l)[:, None]
        )
        if defer_shadow:
            deferred = (torch.where(ok[:, None], contrib, 0.0),
                        (its.p, wo_w, smint, smaxt))
        else:
            vis = ~occluded(sd, its.p, wo_w, smint, smaxt)
            L = L + torch.where((ok & vis)[:, None], contrib, 0.0)

    # ---- Russian roulette + BSDF sampling ---------------------------
    u_rr = lane_uniform(seed, q, du + 5)
    rr_q = torch.clamp_max(torch.amax(beta, dim=-1), RR_MAX)
    rr_q = torch.where(depth >= RR_START, rr_q, 1.0)
    alive = live_hit & (u_rr < rr_q)
    beta = beta / torch.clamp_min(rr_q, 1e-8)[:, None]

    u_lobe = lane_uniform(seed, q, du + 3)
    u_dir = lane_uniform2(seed, q, du + 4)
    s = sample_bsdf(params, wi_local, u_lobe, u_dir)
    beta = beta * s.weight
    alive = alive & (torch.amax(s.weight, dim=-1) > 0.0)
    return its, frame, s, L, beta, alive, n_shadow, deferred


def _path_init(o, d, mint, maxt) -> dict:
    """path_state, and the previous bounce of primary rays: discrete
    (spec), of density 0."""
    n, dev = o.shape[0], o.device
    return {**path_state(o, d, mint, maxt),
            "spec": torch.ones((n,), dtype=torch.bool, device=dev),
            "prev_pdf": torch.zeros((n,), dtype=torch.float32, device=dev)}


def make_path_depth(mode: int, max_depth: int = MAX_DEPTH) -> DepthLoop:
    """Batched path tracer over N camera rays (path.py:42-188): one
    path_vertex for the whole batch per depth until no lane is alive
    (run_depths reads it on the host before each depth past the first)
    or max_depth."""

    def body(sd, st, depth: int, seed, lanes) -> dict:
        o, n, dev = st["o"], st["o"].shape[0], st["o"].device
        alive = st["alive"]
        rays = st["rays"] + alive.sum()
        its, frame, s, L, beta, alive, n_shadow, _ = path_vertex(
            sd, mode, o, st["d"], st["mint"], st["maxt"], alive,
            torch.full((n,), depth, dtype=torch.int32, device=dev),
            st["beta"], st["L"], st["spec"], st["prev_pdf"], seed, lanes)
        return {"o": its.p, "d": to_world(frame, s.wo),
                "mint": torch.full((n,), EPSILON, dtype=torch.float32,
                                   device=dev),
                "maxt": torch.full((n,), 1e30, dtype=torch.float32,
                                   device=dev),
                "L": L, "beta": beta, "alive": alive,
                "spec": s.measure == E_DISCRETE, "prev_pdf": s.pdf,
                "rays": rays + n_shadow}

    return DepthLoop(body, max_depth, _path_init)


class _PathBase(Integrator):
    mode = MIS

    def __init__(self, props):
        self.max_depth = props.get_integer("maxDepth", MAX_DEPTH)

    def make_depth(self, scene, device):
        return make_path_depth(self.mode, self.max_depth)

    def to_string(self):
        return f"{type(self).__name__}[maxDepth={self.max_depth}]"


@register_class("path_mats")
class PathMats(_PathBase):
    mode = MATS


@register_class("path_ems")
class PathEms(_PathBase):
    mode = EMS


@register_class("path_mis")
class PathMis(_PathBase):
    mode = MIS


@register_class("path")
class Path(_PathBase):
    mode = MIS
