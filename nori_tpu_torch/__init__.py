"""nori_tpu_torch: the renderer on PyTorch and CUDA (NVIDIA H100).

Port of the JAX package `nori_tpu`, which stays the reference each
part is tested against.  This package imports torch and never jax.

The numpy-only host layer is copied from `nori_tpu` with its imports
rewritten (registry, objects, props, parser, obj_loader, mesh, emitter,
sampler, accel/bvh, bitmap, exr_piz, scenes_builtin, testing/
hypothesis, tui); `native` builds
the JAX package's C++ runtime from source.  The rest is ported to
tensors; the kernels of the sweep are CUDA C++ under csrc/ (see
accel/sweep.py).

Public entry points:
    load_from_xml(path)                    -> root object (Scene or Test)
    wavefront.render_wavefront(scene, ...) -> image, stats
    render.render_to_files(scene, base)    -> <base>.exr + <base>.png
    main.main(argv)                        -> the CLI (python -m nori_tpu_torch)
    warptest.main(argv)                    -> chi^2 of the sampling warps
"""

from nori_tpu_torch.parser import load_from_xml
from nori_tpu_torch.registry import register_class, create_instance

# importing these modules populates the plugin registry
from nori_tpu_torch import rfilter as _rfilter  # noqa: F401,E402
from nori_tpu_torch import camera as _camera  # noqa: F401,E402
from nori_tpu_torch import sampler as _sampler  # noqa: F401,E402
from nori_tpu_torch import bsdf as _bsdf  # noqa: F401,E402
from nori_tpu_torch import emitter as _emitter  # noqa: F401,E402
from nori_tpu_torch import mesh as _mesh  # noqa: F401,E402
from nori_tpu_torch import scene as _scene  # noqa: F401,E402
from nori_tpu_torch import integrators as _integrators  # noqa: F401,E402
from nori_tpu_torch import testing as _testing  # noqa: F401,E402

__all__ = ["load_from_xml", "register_class", "create_instance"]
