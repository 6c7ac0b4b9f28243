"""Path-tracer plugins: path_mats / path_ems / path_mis / path.

Port of the plugin classes and constants of
`nori_tpu/integrators/path.py`.  Every path-family plugin renders
through the persistent wavefront (nori_tpu_torch.wavefront); `mode`
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

from nori_tpu_torch.registry import register_class
from nori_tpu_torch.integrators.base import Integrator

MAX_DEPTH = 48
RR_START = 3
RR_MAX = 0.95

MATS, EMS, MIS = 0, 1, 2


class _PathBase(Integrator):
    mode = MIS

    def __init__(self, props):
        self.max_depth = props.get_integer("maxDepth", MAX_DEPTH)

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
