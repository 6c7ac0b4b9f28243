// K1 entry_min: per (256-ray tile, 128-triangle tile) minimum slab-entry
// distance over the tile's live rays, clamped to >= 0, +inf when no
// live ray enters the box.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py `_entry_kernel`
// (called through `_entry_min_pallas`).
//
// Bound on the H100: arithmetic.  The output is n_rt * n_tt floats and
// the inputs are 32 B per ray plus 32 B per tile, while the work is
// n_rays * n_tt slab tests (~25 flops each).  Design: one block of 256
// threads per ray tile stages its rays (8 KB, directions already
// inverted) in shared memory; thread j takes triangle tiles j, j+256,
// ... and scans the 256 staged rays with every thread of a warp
// reading the same shared word (a broadcast, no bank conflict), so
// each output is one thread's running minimum and needs no block
// reduction.  The TPU version's 8-ray-tile grid groups and 128-lane
// tile padding are not needed here.
#include "common.cuh"

__global__ void entry_min_kernel(const float* __restrict__ bounds,
                                 const float* __restrict__ rays,
                                 float* __restrict__ out, int n_tt, int n) {
    __shared__ float s_ray[8][TILE_N];
    const int rt = blockIdx.x;
    const int tid = threadIdx.x;
    const int r = rt * TILE_N + tid;
    float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    float dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    s_ray[0][tid] = ox;
    s_ray[1][tid] = oy;
    s_ray[2][tid] = oz;
    s_ray[3][tid] = safe_inv(dx);
    s_ray[4][tid] = safe_inv(dy);
    s_ray[5][tid] = safe_inv(dz);
    s_ray[6][tid] = mint;
    s_ray[7][tid] = maxt;
    __syncthreads();

    for (int j = tid; j < n_tt; j += TILE_N) {
        const float* b = bounds + 8 * j;
        float bb[6] = {b[0], b[1], b[2], b[3], b[4], b[5]};
        float best = __int_as_float(0x7f800000);  // +inf
        for (int k = 0; k < TILE_N; ++k) {
            float kmint = s_ray[6][k], kmaxt = s_ray[7][k];
            if (!(kmint <= kmaxt)) continue;  // idle lane
            float tn;
            if (slab(bb, s_ray[0][k], s_ray[1][k], s_ray[2][k], s_ray[3][k],
                     s_ray[4][k], s_ray[5][k], kmint, kmaxt, &tn)) {
                best = fminf(best, clamp0(tn));
            }
        }
        out[(size_t)rt * n_tt + j] = best;
    }
}

extern "C" int entry_min_launch(const float* bounds, const float* rays,
                                float* out, int n_tt, int n,
                                cudaStream_t stream) {
    int n_rt = n / TILE_N;
    if (n_rt > 0) {
        entry_min_kernel<<<n_rt, TILE_N, 0, stream>>>(bounds, rays, out,
                                                      n_tt, n);
    }
    return (int)cudaGetLastError();
}
