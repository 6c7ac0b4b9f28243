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
// lane, 256 lanes per block, the tile bounds staged in shared memory
// in chunks of BOUNDS_CHUNK boxes (24 KB; the living room's 101
// coarsened groups take one, the ajax stand-in's 1,058 slabs two) and
// read by every thread of a warp at the same address (a broadcast), so
// any tile count is taken.  The TPU version's one-hot group matmul and
// 8-ray-tile grid groups are not needed.
#include "common.cuh"

#define BOUNDS_CHUNK 1024  // tile boxes staged per pass

__global__ void lane_keys_kernel(const float* __restrict__ bounds, int n_tt,
                                 int n_tt_pad, const float* __restrict__ rays,
                                 int n, int* __restrict__ key1,
                                 int* __restrict__ key2) {
    __shared__ float s_b[BOUNDS_CHUNK * 6];  // one chunk of [bmin | bmax]
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = r < n;  // every thread stages, lanes past n only wait
    const int rr = in ? r : 0;
    const float ox = rays[0 * n + rr], oy = rays[1 * n + rr], oz = rays[2 * n + rr];
    const float ix = safe_inv(rays[3 * n + rr]);
    const float iy = safe_inv(rays[4 * n + rr]);
    const float iz = safe_inv(rays[5 * n + rr]);
    const float mint = rays[6 * n + rr], maxt = rays[7 * n + rr];
    const bool live = in && mint <= maxt;
    const int gsz = (n_tt_pad + 29) / 30;
    int first = -1, fine = 0, coarse = 0;
    for (int j0 = 0; j0 < n_tt; j0 += BOUNDS_CHUNK) {
        const int m = min(BOUNDS_CHUNK, n_tt - j0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = threadIdx.x; e < m * 6; e += blockDim.x) {
            s_b[e] = bounds[(j0 + e / 6) * 8 + e % 6];
        }
        __syncthreads();
        if (!live) continue;
        for (int jj = 0; jj < m; ++jj) {
            float tn;
            if (!slab(s_b + 6 * jj, ox, oy, oz, ix, iy, iz, mint, maxt, &tn)) {
                continue;
            }
            const int j = j0 + jj;
            if (first < 0) {
                first = j;
            } else if (j - first <= 20) {
                fine |= 1 << (20 - (j - first));
            }
            coarse |= 1 << max(29 - j / gsz, 0);
        }
    }
    if (!in) return;
    const int f1 = first < 0 ? n_tt_pad : first;
    key1[r] = (min(f1, 1023) << 20) | fine;
    key2[r] = coarse;
}

extern "C" int lane_keys_launch(const float* bounds, int n_tt, int n_tt_pad,
                                const float* rays, int n, int* key1,
                                int* key2, cudaStream_t stream) {
    const int blocks = (n + TILE_N - 1) / TILE_N;
    if (blocks > 0) {
        lane_keys_kernel<<<blocks, TILE_N, 0, stream>>>(
            bounds, n_tt, n_tt_pad, rays, n, key1, key2);
    }
    return (int)cudaGetLastError();
}
