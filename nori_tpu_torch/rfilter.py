"""Image reconstruction filters.

Port of `nori_tpu/rfilter.py` (reference src/rfilter.cpp:28-126:
gaussian/mitchell/tent/box).  Each filter exposes a host-side radius
plus a torch `eval(x)` used by the wavefront's dense film splat.
Parameter defaults match the reference exactly.
"""

from __future__ import annotations

import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class


class ReconstructionFilter(NoriObject):
    class_kind = registry.RFILTER
    radius: float = 0.0

    def eval(self, x):
        raise NotImplementedError


@register_class("gaussian")
class GaussianFilter(ReconstructionFilter):
    """Windowed Gaussian; defaults radius=2, stddev=0.5."""

    def __init__(self, props):
        self.radius = props.get_float("radius", 2.0)
        self.stddev = props.get_float("stddev", 0.5)

    def eval(self, x):
        alpha = -1.0 / (2.0 * self.stddev * self.stddev)
        # the window term is taken in float32, as the JAX package does
        tail = torch.exp(torch.tensor(alpha * self.radius * self.radius,
                                      dtype=torch.float32, device=x.device))
        return torch.clamp_min(torch.exp(alpha * x * x) - tail, 0.0)

    def to_string(self):
        return f"GaussianFilter[radius={self.radius}, stddev={self.stddev}]"


@register_class("mitchell")
class MitchellNetravaliFilter(ReconstructionFilter):
    def __init__(self, props):
        self.radius = props.get_float("radius", 2.0)
        self.B = props.get_float("B", 1.0 / 3.0)
        self.C = props.get_float("C", 1.0 / 3.0)

    def eval(self, x):
        B, C = self.B, self.C
        x = torch.abs(2.0 * x / self.radius)
        x2, x3 = x * x, x * x * x
        inner = (1.0 / 6.0) * (
            (12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2 + (6 - 2 * B)
        )
        outer = (1.0 / 6.0) * (
            (-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
            + (-12 * B - 48 * C) * x + (8 * B + 24 * C)
        )
        return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))

    def to_string(self):
        return f"MitchellNetravaliFilter[radius={self.radius}, B={self.B}, C={self.C}]"


@register_class("tent")
class TentFilter(ReconstructionFilter):
    def __init__(self, props):
        self.radius = 1.0

    def eval(self, x):
        return torch.clamp_min(1.0 - torch.abs(x), 0.0)

    def to_string(self):
        return "TentFilter[]"


@register_class("box")
class BoxFilter(ReconstructionFilter):
    def __init__(self, props):
        self.radius = 0.5

    def eval(self, x):
        return torch.ones_like(x)

    def to_string(self):
        return "BoxFilter[]"
