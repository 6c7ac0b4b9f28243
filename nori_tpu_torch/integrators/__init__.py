"""Integrator plugins (reference: include/nori/integrator.h:34-61).

The port carries the path family, rendered by the persistent wavefront.
The JAX package's other integrators are registered here as stubs so a
scene that names one fails with a clear error instead of "unknown
plugin".
"""

from nori_tpu_torch.integrators import path  # noqa: F401
from nori_tpu_torch.integrators.base import Integrator  # noqa: F401
from nori_tpu_torch.registry import NoriError, register_class

PATH_FAMILY = ("path", "path_mats", "path_ems", "path_mis")
NOT_PORTED = ("normals", "simple", "ao", "whitted")


def _not_ported(name: str):
    class _NotPorted(Integrator):
        def __init__(self, props):
            raise NoriError(
                f"integrator '{name}' is not yet ported to nori_tpu_torch "
                f"(ported: {', '.join(PATH_FAMILY)}); render it with "
                f"nori_tpu")

    register_class(name)(_NotPorted)


for _name in NOT_PORTED:
    _not_ported(_name)
