"""Render driver for the path family.

Port of `nori_tpu/render.py:render_to_files` for the path-family
integrators, which render through the persistent wavefront.  The JAX
package's batched pass for the other integrators is not ported yet.
"""

from __future__ import annotations

#: RNG stream of the pixel jitter, shared by camera rays and the splat
JITTER_STREAM = 0xF000


def render_to_files(scene, out_base: str, spp: int | None = None,
                    seed: int = 0, verbose: bool = False, device=None,
                    n_lanes: int = 131072):
    """Render and write <base>.exr + tonemapped <base>.png
    (src/main.cpp:140-150).  Returns (image, stats)."""
    from nori_tpu_torch.bitmap import write_exr, write_png
    from nori_tpu_torch.integrators import PATH_FAMILY
    from nori_tpu_torch.registry import NoriError
    from nori_tpu_torch.wavefront import render_wavefront

    name = scene.integrator.plugin_name
    if name not in PATH_FAMILY:
        raise NoriError(f"integrator '{name}' is not yet ported to "
                        "nori_tpu_torch")
    img, stats = render_wavefront(scene, spp=spp, seed=seed,
                                  n_lanes=n_lanes, verbose=verbose,
                                  device=device)
    write_exr(out_base + ".exr", img)
    write_png(out_base + ".png", img)
    return img, stats
