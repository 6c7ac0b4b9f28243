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

#define TILE_N 256    // rays per ray tile (one block)
#define FINE_T 128    // triangles per triangle tile (resident sweep)
#define STREAM_T 512  // triangles per slab (streamed sweep)

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

// Block-wide max of one int per thread (blockDim.x == TILE_N); s_buf
// holds TILE_N / 32 ints.  Every thread of the block must call it.
__device__ __forceinline__ int block_max_int(int v, int* s_buf) {
    v = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) s_buf[threadIdx.x >> 5] = v;
    __syncthreads();
    int m = s_buf[0];
#pragma unroll
    for (int w = 1; w < TILE_N / 32; ++w) m = max(m, s_buf[w]);
    __syncthreads();
    return m;
}

// t_hi contribution of one lane: its useful t as non-negative float bits
__device__ __forceinline__ int t_cap_bits(bool live, float bt, float maxt) {
    float tc = live ? fminf(bt, maxt) : 0.0f;
    return __float_as_int(clamp0(tc));
}

// One ray against staged triangle c of a tile whose operand rows are
// STRIDE floats apart; the expressions round exactly as the plain
// versions in accel/sweep.py (left-to-right sums, no FMA).
template <bool BW, int STRIDE>
__device__ __forceinline__ void pair_test(
        const float* tri, int c, float ox, float oy, float oz,
        float dx, float dy, float dz, float mint, float maxt,
        bool* hit, float* t_out) {
    auto R = [&](int i) { return tri[i * STRIDE + c]; };  // operand row i
    bool ok;
    float t, u, v;
    if constexpr (BW) {
        // rows [n(3) | d_plane | U(3) | u_w | V(3) | v_w]
        float den = R(0) * dx + R(1) * dy + R(2) * dz;
        ok = fabsf(den) > 1e-8f;
        float inv_den = 1.0f / (ok ? den : 1.0f);
        t = -(R(0) * ox + R(1) * oy + R(2) * oz + R(3)) * inv_den;
        float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
        u = R(4) * px + R(5) * py + R(6) * pz + R(7);
        v = R(8) * px + R(9) * py + R(10) * pz + R(11);
    } else {
        // rows [v0(3) | e1(3) | e2(3)]
        float e1x = R(3), e1y = R(4), e1z = R(5);
        float e2x = R(6), e2y = R(7), e2z = R(8);
        float px = dy * e2z - dz * e2y;
        float py = dz * e2x - dx * e2z;
        float pz = dx * e2y - dy * e2x;
        float det = e1x * px + e1y * py + e1z * pz;
        ok = fabsf(det) > 1e-8f;
        float inv_det = 1.0f / (ok ? det : 1.0f);
        float tx = ox - R(0), ty = oy - R(1), tz = oz - R(2);
        u = (tx * px + ty * py + tz * pz) * inv_det;
        float qx = ty * e1z - tz * e1y;
        float qy = tz * e1x - tx * e1z;
        float qz = tx * e1y - ty * e1x;
        v = (dx * qx + dy * qy + dz * qz) * inv_det;
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    }
    *hit = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
           (u + v <= 1.0f) && (t >= mint) && (t <= maxt);
    *t_out = t;
}
