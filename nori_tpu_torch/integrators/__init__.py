"""Integrators (reference: include/nori/integrator.h:34-61).

Each integrator plugin exposes `make_depth(scene, device)`, its
estimate as a depth loop over the whole batch (base.DepthLoop: init,
one depth's body, max_depth), and through it `make_li(scene, device)`
returning a function

    li(scene_data, o, d, mint, maxt, seed, lanes) -> ((N, 3), aux)

over a batch of N rays, with aux["rays"] the rays it traced.  `lanes`
are global sample ids feeding the counter-based RNG.  The reference's
recursive per-ray `Li(scene, sampler, ray)` becomes that depth loop
(base.run_depths); the graphed batch driver (render.py) replays its
depths one by one.

Plugins: normals, simple, ao, whitted, path_mats, path_ems, path_mis,
path.  The path family renders through the persistent wavefront, the
others through `render.render`.
"""

from nori_tpu_torch.integrators import (  # noqa: F401
    path, simple_integrators, whitted)
from nori_tpu_torch.integrators.base import Integrator  # noqa: F401

PATH_FAMILY = ("path", "path_mats", "path_ems", "path_mis")
