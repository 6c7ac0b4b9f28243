"""Plugin factory registry.

Replaces NoriObjectFactory (include/nori/object.h:112-161): XML `type`
attributes resolve to Python classes through this table.  Class kinds
mirror the reference's EClassType RTTI enum (object.h:41-56) so the
parser can validate that e.g. a <bsdf> tag constructed a BSDF.
"""

from __future__ import annotations

from typing import Callable, Dict


class NoriError(RuntimeError):
    """Equivalent of NoriException."""


# class-kind strings (stand-in for the EClassType enum)
SCENE = "scene"
MESH = "mesh"
BSDF = "bsdf"
PHASE = "phase"
EMITTER = "emitter"
MEDIUM = "medium"
CAMERA = "camera"
INTEGRATOR = "integrator"
SAMPLER = "sampler"
TEST = "test"
RFILTER = "rfilter"

CLASS_KINDS = (
    SCENE, MESH, BSDF, PHASE, EMITTER, MEDIUM, CAMERA, INTEGRATOR,
    SAMPLER, TEST, RFILTER,
)

_registry: Dict[str, Callable] = {}


def register_class(name: str):
    """Decorator: `@register_class("diffuse")` — mirrors NORI_REGISTER_CLASS."""

    def deco(cls):
        # later registrations (e.g. module reloads) replace earlier ones
        _registry[name] = cls
        cls.plugin_name = name
        return cls

    return deco


def create_instance(name: str, props):
    if name not in _registry:
        raise NoriError(
            f"A constructor for class '{name}' could not be found "
            f"(registered: {sorted(_registry)})"
        )
    return _registry[name](props)


def is_registered(name: str) -> bool:
    return name in _registry
