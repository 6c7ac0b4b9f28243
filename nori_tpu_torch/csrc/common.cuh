// Shared helpers of the sweep kernels (nori_tpu_torch/accel/sweep.py).
//
// Layouts, as in the JAX package: rays (8, N) row-major
// [ox, oy, oz, dx, dy, dz, mint, maxt] with N a multiple of TILE_N;
// tile bounds (n_tt, 8) row-major [bmin xyz | bmax xyz | pad 2].
//
// Built without FMA contraction (--fmad=false) and without fast math,
// so every float expression rounds as its plain PyTorch version does.
#pragma once

#include <cuda_runtime.h>

#define TILE_N 256  // rays per ray tile (one block)
#define FINE_T 128  // triangles per triangle tile

// 1/c with |c| clamped away from zero, keeping the sign (the JAX
// package's slab-test reciprocal).
__device__ __forceinline__ float safe_inv(float c) {
    float cc = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
    return 1.0f / cc;
}

// Slab test of one ray against one AABB: entry distance tn and
// whether the box is a candidate for the interval [mint, maxt].
// The min/max forms only feed comparisons here, so their handling of
// signed zeros does not matter.
__device__ __forceinline__ bool slab(
        const float* b, float ox, float oy, float oz,
        float ix, float iy, float iz, float mint, float maxt, float* tn_out) {
    float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
    float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
    float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    *tn_out = tn;
    return (tn <= tf) && (tf >= mint) && (tn <= maxt);
}

// max(x, +0): a non-positive x (and -0) becomes +0, as XLA's maximum
// does, so the float's bits order like the float itself.
__device__ __forceinline__ float clamp0(float x) { return x > 0.0f ? x : 0.0f; }
