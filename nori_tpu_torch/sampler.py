"""Sample generators.

The reference Sampler (include/nori/sampler.h:62-107) is a mutable
stream cloned per worker thread and seeded per tile
(src/independent.cpp:33-77).  On TPU the equivalent is stateless: the
Independent sampler just holds `sample_count` and a base seed; actual
uniforms come from counter-based hashes of (seed, lane, stream) inside
the jitted integrators (see nori_tpu_torch.core.rng) so every (pixel, sample,
bounce, dimension) lookup is reproducible under any sharding.
"""

from __future__ import annotations

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class


class Sampler(NoriObject):
    class_kind = registry.SAMPLER
    sample_count: int = 1


@register_class("independent")
class Independent(Sampler):
    def __init__(self, props):
        self.sample_count = props.get_integer("sampleCount", 1)
        self.seed = props.get_integer("seed", 0)

    def to_string(self):
        return f"Independent[sampleCount={self.sample_count}]"
