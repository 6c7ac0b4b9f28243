// K3 lane_keys: per-lane coherence-sort keys for the wavefront.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py `_lane_key_kernel`
// (called through `_lane_keys_impl` / `lane_sort_keys`).
//
//   key1 = (min(first candidate tile, 1023) << 20) | fine mask, where
//          bit (20 - k) of the fine mask says tile first+k is a
//          candidate, k = 1..20; a lane with no candidate gets
//          first = n_tt_pad (the 128-padded tile count) and mask 0.
//   key2 = 30-bit coarse OR-mask: bit max(29 - g, 0) is set when any
//          tile of group g = tile / gsz is a candidate,
//          gsz = ceil(n_tt_pad / 30).
//
// The TPU kernel reads the fine mask out of the mantissa of a float sum
// of powers of two; this kernel builds it as an integer, which equals
// the float form except where candidates at offsets >= 21 round into
// the sum (the keys then order lanes slightly differently; no sample
// value depends on lane order).
//
// Bound on the H100: arithmetic, n_lanes * n_tt slab tests with a few
// integer ops each; the output is 8 B per lane.  Design: one thread per
// lane, 256 lanes per block, the tile bounds (n_tt * 24 B, 2.4 KB for
// the living room's 101 coarsened groups) staged in shared memory and
// read by every thread of a warp at the same address (a broadcast).
// The TPU version's one-hot group matmul and 8-ray-tile grid groups
// are not needed.
#include "common.cuh"

__global__ void lane_keys_kernel(const float* __restrict__ bounds, int n_tt,
                                 int n_tt_pad, const float* __restrict__ rays,
                                 int n, int* __restrict__ key1,
                                 int* __restrict__ key2) {
    extern __shared__ float s_b[];  // (n_tt, 6) [bmin | bmax]
    for (int e = threadIdx.x; e < n_tt * 6; e += blockDim.x) {
        s_b[e] = bounds[(e / 6) * 8 + e % 6];
    }
    __syncthreads();
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    const float ix = safe_inv(rays[3 * n + r]);
    const float iy = safe_inv(rays[4 * n + r]);
    const float iz = safe_inv(rays[5 * n + r]);
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    const int gsz = (n_tt_pad + 29) / 30;
    int first = -1, fine = 0, coarse = 0;
    if (mint <= maxt) {
        for (int j = 0; j < n_tt; ++j) {
            float tn;
            if (!slab(s_b + 6 * j, ox, oy, oz, ix, iy, iz, mint, maxt, &tn)) {
                continue;
            }
            if (first < 0) {
                first = j;
            } else if (j - first <= 20) {
                fine |= 1 << (20 - (j - first));
            }
            coarse |= 1 << max(29 - j / gsz, 0);
        }
    }
    const int f1 = first < 0 ? n_tt_pad : first;
    key1[r] = (min(f1, 1023) << 20) | fine;
    key2[r] = coarse;
}

extern "C" int lane_keys_launch(const float* bounds, int n_tt, int n_tt_pad,
                                const float* rays, int n, int* key1,
                                int* key2, cudaStream_t stream) {
    const int blocks = (n + TILE_N - 1) / TILE_N;
    const size_t smem = (size_t)n_tt * 6 * sizeof(float);
    if (blocks > 0) {
        lane_keys_kernel<<<blocks, TILE_N, smem, stream>>>(
            bounds, n_tt, n_tt_pad, rays, n, key1, key2);
    }
    return (int)cudaGetLastError();
}
