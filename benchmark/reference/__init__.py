"""The plain reference the benchmark holds the program's images to.

Plain numpy and PyTorch.  It imports neither `jax` nor `nori_tpu` nor
anything of `nori_tpu_torch`: it starts from a configuration's raw scene
description and works out again every table the program derives from
it.  The pieces of the program's semantics it needs (the counter-based
RNG, the BSDF and warp formulas, the camera and the film's filter, the
order of the triangle soup) are frozen copies kept here.
"""
