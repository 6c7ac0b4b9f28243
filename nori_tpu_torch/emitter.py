"""Emitters.

The reference ships only an empty Emitter interface (include/nori/
emitter.h:28-36); the `area` plugin plus its sampling routine are
required by 60 scene uses (e.g. scenes/pa5/cbox/cbox_mis.xml:56-61) and
the pa4/pa5 t-tests.  Our design: an area light attached to a mesh with
constant radiance; device-side sampling draws points uniformly over the
aggregate area of ALL emissive triangles via one scene-level CDF (see
nori_tpu_torch.scene.EmitterData), giving pdf_area = 1/totalArea — a valid
uniform-area strategy whose estimator expectation matches the
reference fixtures.
"""

from __future__ import annotations

import numpy as np

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class


class Emitter(NoriObject):
    class_kind = registry.EMITTER


@register_class("area")
class AreaLight(Emitter):
    def __init__(self, props):
        self.radiance = props.get_color("radiance")

    def to_string(self):
        return f"AreaLight[radiance={self.radiance.tolist()}]"
