"""Intersection configuration of the port.

The JAX package's switches (`nori_tpu/config.py`), read when a query
runs, not when a module is imported, so a caller (or a test) can set
them between renders:

  accel_mode     the intersection backend, read by resolve_accel:
                 "pallas" (the default, keeping the JAX package's name)
                 the sweeps (K1-K5: the port's hand-written kernels on
                 CUDA, their plain versions on the CPU); "scan" the
                 chunked Moller-Trumbore scan of the whole soup and
                 "bvh" the stack walk of the wide BVH, both plain
                 PyTorch (accel.traverse) and kept as references.  The
                 JAX package's "auto" has no counterpart: it picks the
                 scan or the BVH on a CPU, which has no Pallas, whereas
                 the sweeps run on every device here.
  USE_BW_SWEEP   sweep the Baldwin-Weber operand (`tri_bw`); False
                 sweeps the Moller-Trumbore soup (`tri_packed`).
  USE_MXU_SWEEP  resident scenes sweep the matmul-form operand
                 (`tri_mxu`, kernel K2-mxu).  The merged step's mixed
                 sweep ignores it, as the JAX package's does.
  STREAM_CULL_T  streamed scenes gate their pair tests by the boxes of
                 sub-blocks of this many triangles (kernel K5-cull, the
                 JAX package's `n_sub > 1`) in place of the scene's own
                 sub-blocks of sweep.STREAM_G, by which every streamed
                 sweep is gated on either operand (K5); 0 keeps those.
                 Taken only with the Moller-Trumbore operand
                 (USE_BW_SWEEP False), as the JAX package takes it, and
                 only for a divisor of STREAM_T smaller than it.
  MERGED_SWEEP   the wavefront's merged step: one mixed launch (kernel
                 K4) traces the next bounce's closest hits and this
                 step's shadow rays; NEE modes on resident scenes only.

and, read when a wavefront stepper is built:

  SORT_KEY_COARSEN  the wavefront's sort keys (kernel K3) are taken on
                 tile boxes grouped this many at a time; None takes
                 wavefront.key_coarsen's rule (8 on streamed scenes, 4
                 above 256 tiles, else 1), a number pins
                 max(1, int(number)).  Lane order changes no sample.

The defaults are the JAX package's, less its auto heuristics
(`auto_merged_sweep`, visit widths, key caps), which are TPU
measurements: MERGED_SWEEP is False, which changes no sample value.
"""

from __future__ import annotations

ACCEL_MODES = ("pallas", "scan", "bvh")

accel_mode: str = "pallas"
USE_BW_SWEEP: bool = True
USE_MXU_SWEEP: bool = False
STREAM_CULL_T: int = 0
MERGED_SWEEP: bool = False
SORT_KEY_COARSEN: int | None = None


def resolve_accel() -> str:
    """The backend a query takes now: accel_mode, checked."""
    if accel_mode not in ACCEL_MODES:
        raise ValueError(f"config.accel_mode {accel_mode!r} is not one of "
                         f"{ACCEL_MODES}")
    return accel_mode
