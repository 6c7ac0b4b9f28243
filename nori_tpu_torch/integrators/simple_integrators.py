"""normals / simple / ao integrators.

Port of `nori_tpu/integrators/simple_integrators.py`; behaviour pinned
by the pa1-pa3 scenes:
  * normals — shade with |shading normal| (scenes/pa1/bunny.xml).
  * simple  — point light with `position`/`energy` params:
              Li = energy/(4 pi^2) * max(0, cos) / r^2 * V
              (scenes/pa3/ajax-simple.xml:8-11).
  * ao      — cosine-weighted ambient occlusion, one visibility sample
              per call (scenes/pa3/ajax-ao.xml).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nori_tpu_torch import warp
from nori_tpu_torch.accel.traverse import intersect, occluded
from nori_tpu_torch.core.vecmath import EPSILON, dot, make_frame, to_world
from nori_tpu_torch.integrators.base import Integrator, lane_uniform2
from nori_tpu_torch.interaction import fill_interaction_fast
from nori_tpu_torch.registry import register_class


def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64, device=like.device)


@register_class("normals")
class NormalsIntegrator(Integrator):
    def __init__(self, props):
        pass

    def make_li(self, scene):
        def li(sd, o, d, mint, maxt, seed, lanes):
            hit = intersect(sd, o, d, mint, maxt)
            its = fill_interaction_fast(sd, hit, o, d)
            return (torch.where(its.valid[:, None], torch.abs(its.sh_n), 0.0),
                    {"rays": _count(o.shape[0], o)})

        return li

    def to_string(self):
        return "NormalsIntegrator[]"


@register_class("simple")
class SimpleIntegrator(Integrator):
    def __init__(self, props):
        self.position = props.get_point("position", np.zeros(3))
        self.energy = props.get_color("energy", np.ones(3))

    def make_li(self, scene):
        def li(sd, o, d, mint, maxt, seed, lanes):
            light_p = torch.as_tensor(self.position, dtype=torch.float32,
                                      device=o.device)
            energy = torch.as_tensor(self.energy, dtype=torch.float32,
                                     device=o.device)
            hit = intersect(sd, o, d, mint, maxt)
            its = fill_interaction_fast(sd, hit, o, d)
            dvec = light_p - its.p
            r2 = torch.clamp_min(torch.sum(dvec * dvec, dim=-1), 1e-20)
            r = torch.sqrt(r2)
            wo = dvec / r[:, None]
            cos = torch.clamp_min(dot(its.sh_n, wo), 0.0)
            vis = ~occluded(sd, its.p, wo, torch.full_like(r, EPSILON),
                            r * (1.0 - 1e-4))
            val = energy[None, :] * (
                cos * vis / (4.0 * math.pi * math.pi * r2))[:, None]
            return (torch.where(its.valid[:, None], val, 0.0),
                    {"rays": _count(2 * o.shape[0], o)})

        return li

    def to_string(self):
        return (
            f"SimpleIntegrator[position={self.position.tolist()}, "
            f"energy={self.energy.tolist()}]"
        )


@register_class("ao")
class AmbientOcclusionIntegrator(Integrator):
    def __init__(self, props):
        pass

    def make_li(self, scene):
        def li(sd, o, d, mint, maxt, seed, lanes):
            hit = intersect(sd, o, d, mint, maxt)
            its = fill_interaction_fast(sd, hit, o, d)
            frame = make_frame(its.sh_n)
            wo_local = warp.square_to_cosine_hemisphere(
                lane_uniform2(seed, lanes, 0))
            wo = to_world(frame, wo_local)
            n = its.p.shape[0]
            vis = ~occluded(sd, its.p, wo, torch.full_like(its.t, EPSILON),
                            torch.full_like(its.t, 1e30))
            # estimator: V * cos/pi / (cos/pi) = V
            val = vis.to(torch.float32)[:, None].expand(n, 3)
            return (torch.where(its.valid[:, None], val, 0.0),
                    {"rays": _count(2 * o.shape[0], o)})

        return li

    def to_string(self):
        return "AmbientOcclusionIntegrator[]"
