// K2 resident_sweep: closest-hit or any-hit ray/triangle sweep that
// walks each ray tile's sorted candidate keys and exits at the skyline.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py
// `_mt_resident_kernel` (closest and any-hit forms, with the
// Baldwin-Weber `_bw_block` or the Moller-Trumbore `_mt_block` pair
// test), called through `_resident_call` / `mt_sweep_resident`.
//
// Contract: keys (n_rt, n_keys) int32, each row ascending, each key the
// tile's minimum entry distance bits with the tile index in the low
// idx_bits bits (ray_tile_entry_keys).  Output t (N,) float32 and idx
// (N,) int32, idx -1 on a miss.  Ties in t keep the lowest triangle
// index.  For any-hit only idx >= 0 is meaningful.
//
// Bound on the H100: arithmetic in the pair test (~40 flops BW, ~56
// MT) and, per visit, the block-wide skyline reduction.  Design: one
// block per 256-ray tile, one thread per ray.  Each visited tile's 128
// triangles (12 or 9 rows, at most 6 KB) are staged in shared memory
// and every thread tests its ray against all of them, reading the same
// shared word as the rest of its warp (a broadcast).  After a visit
// the block recomputes t_hi, the largest useful t over its live rays,
// as an integer max of the float bits (all values >= 0, so the int
// order is the float order), and stops at the first key whose entry
// bits exceed it; keys are compared as integers, so a non-candidate
// key (inf or NaN bits) ends the walk.  Any-hit stops once every live
// ray has a hit.  The whole operand stays in device memory (2.5 MB for
// the 51.7k-triangle living room, resident in the 50 MB L2); the TPU's
// VMEM residency, SMEM key chunking, key-row cap with its all-tiles
// fallback and visit width are not needed: one launch covers all rays
// with uncapped key rows and gives the same (t, idx).
#include "common.cuh"

template <bool BW, bool ANY_HIT>
__global__ void resident_sweep_kernel(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        float* __restrict__ t_out, int* __restrict__ idx_out) {
    constexpr int ROWS = BW ? 12 : 9;
    __shared__ float s_tri[ROWS][FINE_T];
    __shared__ int s_red[TILE_N / 32];
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    const float dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    const bool live = mint <= maxt;

    float bt = __int_as_float(0x7f800000);  // +inf
    int bi = -1;
    int t_hi = block_max_int(t_cap_bits(live, bt, maxt), s_red);
    bool alive = __syncthreads_or(live) != 0;
    const int* row = keys + (size_t)rt * n_keys;

    for (int k = 0; k < n_keys && alive; ++k) {
        const int key = row[k];
        if ((key & ~idx_mask) > t_hi) break;  // skyline: int compare
        const int j = key & idx_mask;
        for (int e = threadIdx.x; e < ROWS * FINE_T; e += TILE_N) {
            const int rr = e / FINE_T, cc = e - rr * FINE_T;
            s_tri[rr][cc] = tris[(size_t)rr * T + (size_t)j * FINE_T + cc];
        }
        __syncthreads();
        if (live && !(ANY_HIT && bi >= 0)) {
            const int base = j * FINE_T;
            for (int c = 0; c < FINE_T; ++c) {
                bool hit;
                float t;
                pair_test<BW, FINE_T>(&s_tri[0][0], c, ox, oy, oz, dx, dy,
                                      dz, mint, maxt, &hit, &t);
                if (hit && (t < bt || (t == bt && base + c < bi))) {
                    bt = t;
                    bi = base + c;
                }
            }
        }
        if (ANY_HIT) {
            const bool need = live && bi < 0;
            alive = __syncthreads_or(need) != 0;
            t_hi = block_max_int(t_cap_bits(need, bt, maxt), s_red);
        } else {
            t_hi = block_max_int(t_cap_bits(live, bt, maxt), s_red);
            alive = t_hi > 0;
        }
    }
    t_out[r] = bt;
    idx_out[r] = bi;
}

extern "C" int resident_sweep_launch(const float* tris, int rows, int T,
                                     const int* keys, int n_keys,
                                     int idx_bits, const float* rays, int n,
                                     float* t_out, int* idx_out, int any_hit,
                                     cudaStream_t stream) {
    const int n_rt = n / TILE_N;
    const int idx_mask = (1 << idx_bits) - 1;
    if (n_rt > 0) {
#define LAUNCH(BW, AH)                                                  \
    resident_sweep_kernel<BW, AH><<<n_rt, TILE_N, 0, stream>>>(         \
        tris, T, keys, n_keys, idx_mask, rays, n, t_out, idx_out)
        if (rows == 12) {
            if (any_hit) LAUNCH(true, true); else LAUNCH(true, false);
        } else {
            if (any_hit) LAUNCH(false, true); else LAUNCH(false, false);
        }
#undef LAUNCH
    }
    return (int)cudaGetLastError();
}
