"""Integrator base class + shared light-transport helpers.

Port of `nori_tpu/integrators/base.py` (the parts the integrators
use).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nori_tpu_torch import registry, spans
from nori_tpu_torch.bsdf import BSDFParams
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.core.vecmath import EPSILON, normalize
from nori_tpu_torch.core.dpdf import sample_discrete
from nori_tpu_torch.core import rng


def ray_state(o, d, mint, maxt) -> dict:
    """The state of a depth loop that carries nothing but its rays."""
    return {"o": o, "d": d, "mint": mint, "maxt": maxt}


def path_state(o, d, mint, maxt) -> dict:
    """The state of a depth loop over paths: the rays, radiance L = 0,
    throughput beta = 1, every lane alive and no ray traced yet."""
    n, dev = o.shape[0], o.device
    return {**ray_state(o, d, mint, maxt),
            "L": torch.zeros((n, 3), dtype=torch.float32, device=dev),
            "beta": torch.ones((n, 3), dtype=torch.float32, device=dev),
            "alive": torch.ones((n,), dtype=torch.bool, device=dev),
            "rays": torch.zeros((), dtype=torch.int64, device=dev)}


class DepthLoop(NamedTuple):
    """An integrator's radiance estimate over a batch of N rays, as a
    loop of depths over one state (a dict of tensors): init(o, d, mint,
    maxt) makes the state of the camera rays, body(sd, state, depth,
    seed, lanes) runs one depth (depth a Python int; lanes the global
    sample ids keying the RNG) and returns the next state.  run_depths
    runs depth 0, then each depth up to max_depth while state["alive"]
    holds a live lane; the estimate is state["L"] (N, 3) and the rays
    traced state["rays"], a 0-d count.  A body with no continuation
    takes max_depth 1 and needs no "alive"."""

    body: Callable
    max_depth: int = 1
    init: Callable = ray_state


def call_stage(key, fn, state):
    """The `run` of run_depths that calls each stage: fn(state)."""
    return fn(state)


def run_depths(body, state: dict, max_depth: int, run=call_stage) -> dict:
    """The batch depth loop: state = body(state, 0), then state =
    body(state, k) for k = 1, 2, ... below max_depth while a lane of
    state["alive"] is live.  The host reads that before each depth past
    the first (span `sync.alive`; depth 0's lanes are all live), each
    depth in a span `batch.depth`.  Depth k runs as run(k, fn, state)
    with fn(state) = body(state, k): the graphed batch driver's run
    replays it."""
    for k in range(max_depth):
        with spans.span("batch.depth"):
            if k:
                with spans.sync("alive"):
                    if not bool(state["alive"].any()):
                        break
            state = run(k, lambda s, k=k: body(s, k), state)
    return state


class Integrator(NoriObject):
    class_kind = registry.INTEGRATOR

    def preprocess(self, scene):
        """Hook matching Integrator::preprocess (integrator.h:42)."""

    def make_depth(self, scene, device) -> DepthLoop:
        """The integrator's DepthLoop on `device`."""
        raise NotImplementedError

    def make_li(self, scene, device):
        """li(sd, o, d, mint, maxt, seed, lanes) -> ((N, 3) radiance,
        {"rays": count tensor}) over a batch of N rays on `device`;
        lanes are the global sample ids keying the RNG.  It runs
        make_depth's loop (run_depths)."""
        loop = self.make_depth(scene, device)

        def li(sd, o, d, mint, maxt, seed, lanes):
            state = run_depths(
                lambda s, k: loop.body(sd, s, k, seed, lanes),
                loop.init(o, d, mint, maxt), loop.max_depth)
            return state["L"], {"rays": state["rays"]}

        return li


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
