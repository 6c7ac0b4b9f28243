// K5 stream_sweep: closest-hit or any-hit ray/triangle sweep for
// soups too large for the resident layout, walking each ray tile's
// sorted candidate keys over 512-triangle slabs.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py
// `_mt_stream_kernel` (closest and any-hit forms, Baldwin-Weber or
// Moller-Trumbore operand, without sub-slab culling), called through
// `_stream_call` / `mt_sweep_streamed`.
//
// Contract: tris (16, T) float32, T a multiple of STREAM_T, rows
// [bw(12) | 0 x 4] (use_bw) or [v0 | e1 | e2 | 0 x 7]; keys (n_rt,
// n_keys) int32 from ray_tile_entry_keys on the (T / STREAM_T, 8) slab
// bounds, each key a slab's minimum entry distance bits with the slab
// index in the low idx_bits bits.  Output t (N,) float32 and idx (N,)
// int32, idx -1 on a miss; ties in t keep the lowest triangle index.
// For any-hit only idx >= 0 is meaningful.
//
// Bound on the H100: the pair tests (~40 flops BW, ~56 MT, 512 per ray
// and visit) and the copy of each visited slab; which one dominates is
// not settled (PERF.md: MT, with more flops but 18 KB per visit and 36
// KB of shared memory per block, ran faster than BW with 24 KB and
// 48 KB).  The BW operand of the 541,696-triangle ajax stand-in is
// 26 MB in its 12 read rows, so it stays in the 50 MB L2 after the
// first touches.  Design: one block per 256-ray tile, one thread per
// ray, K2's walk (integer skyline exit, any-hit exit) over slabs.  Each visited slab's read rows (12 or
// 9 x 2 KB, each row 16-byte aligned and contiguous) are staged in a
// shared-memory double buffer by cp.async in 16-byte chunks: the copy
// for key k+1 is issued before the test of key k, and the block waits
// for the one copy still in flight at exit (the bookkeeping invariant
// of the TPU kernel, pallas_mt.py:541-543).  A copy is issued only for
// a key whose entry bound does not already fail the skyline, since
// t_hi never rises.  The TPU's 16-row padding (DMA alignment), SMEM
// ray chunking, key caps and overflow fallback are not needed: one
// launch covers all rays with uncapped keys.
#include <cuda_pipeline.h>

#include "common.cuh"

template <bool BW, bool ANY_HIT>
__global__ void __launch_bounds__(TILE_N) stream_sweep_kernel(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        float* __restrict__ t_out, int* __restrict__ idx_out) {
    constexpr int ROWS = BW ? 12 : 9;
    constexpr int SLAB = ROWS * STREAM_T;   // floats in one buffer
    constexpr int ROW_CHUNKS = STREAM_T / 4;  // 16-byte chunks per row
    extern __shared__ __align__(16) float s_buf[];  // [2][ROWS][STREAM_T]
    __shared__ int s_red[TILE_N / 32];
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    const float dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    const bool live = mint <= maxt;

    // stage slab j's read rows into buffer `slot` (one commit group)
    auto issue = [&](int j, int slot) {
        float* dst = s_buf + slot * SLAB;
        const float* src = tris + (size_t)j * STREAM_T;
        for (int e = threadIdx.x; e < ROWS * ROW_CHUNKS; e += TILE_N) {
            const int rr = e / ROW_CHUNKS, cc = (e - rr * ROW_CHUNKS) * 4;
            __pipeline_memcpy_async(dst + rr * STREAM_T + cc,
                                    src + (size_t)rr * T + cc, 16);
        }
        __pipeline_commit();
    };

    float bt = __int_as_float(0x7f800000);  // +inf
    int bi = -1;
    int t_hi = block_max_int(t_cap_bits(live, bt, maxt), s_red);
    bool alive = __syncthreads_or(live) != 0;
    const int* row = keys + (size_t)rt * n_keys;

    // every condition below is uniform across the block
    if (n_keys > 0 && alive && (row[0] & ~idx_mask) <= t_hi) {
        issue(row[0] & idx_mask, 0);
    }
    for (int k = 0; k < n_keys && alive; ++k) {
        const int key = row[k];
        if ((key & ~idx_mask) > t_hi) break;  // skyline: int compare
        if (k + 1 < n_keys && (row[k + 1] & ~idx_mask) <= t_hi) {
            issue(row[k + 1] & idx_mask, (k + 1) & 1);
        } else {
            __pipeline_commit();  // empty group: copy k stays second newest
        }
        __pipeline_wait_prior(1);  // this thread's chunks of slab k landed
        __syncthreads();           // ... and every other thread's
        const float* slab_k = s_buf + (k & 1) * SLAB;
        if (live && !(ANY_HIT && bi >= 0)) {
            const int base = (key & idx_mask) * STREAM_T;
            for (int c = 0; c < STREAM_T; ++c) {
                bool hit;
                float t;
                pair_test<BW, STREAM_T>(slab_k, c, ox, oy, oz, dx, dy, dz,
                                        mint, maxt, &hit, &t);
                if (hit && (t < bt || (t == bt && base + c < bi))) {
                    bt = t;
                    bi = base + c;
                }
            }
        }
        // the reductions end in __syncthreads, so no thread still reads
        // buffer k & 1 when the next iteration refills it
        if (ANY_HIT) {
            const bool need = live && bi < 0;
            alive = __syncthreads_or(need) != 0;
            t_hi = block_max_int(t_cap_bits(need, bt, maxt), s_red);
        } else {
            t_hi = block_max_int(t_cap_bits(live, bt, maxt), s_red);
            alive = t_hi > 0;
        }
    }
    __pipeline_wait_prior(0);  // the copy still in flight, if any
    t_out[r] = bt;
    idx_out[r] = bi;
}

template <bool BW, bool AH>
static int launch(const float* tris, int T, const int* keys, int n_keys,
                  int idx_mask, const float* rays, int n, float* t_out,
                  int* idx_out, cudaStream_t stream) {
    const int smem = 2 * (BW ? 12 : 9) * STREAM_T * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        stream_sweep_kernel<BW, AH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stream_sweep_kernel<BW, AH><<<n / TILE_N, TILE_N, smem, stream>>>(
        tris, T, keys, n_keys, idx_mask, rays, n, t_out, idx_out);
    return (int)cudaGetLastError();
}

extern "C" int stream_sweep_launch(const float* tris, int use_bw, int T,
                                   const int* keys, int n_keys, int idx_bits,
                                   const float* rays, int n, float* t_out,
                                   int* idx_out, int any_hit,
                                   cudaStream_t stream) {
    const int idx_mask = (1 << idx_bits) - 1;
    if (n < TILE_N) return (int)cudaGetLastError();
    if (use_bw) {
        return any_hit ? launch<true, true>(tris, T, keys, n_keys, idx_mask,
                                            rays, n, t_out, idx_out, stream)
                       : launch<true, false>(tris, T, keys, n_keys, idx_mask,
                                             rays, n, t_out, idx_out, stream);
    }
    return any_hit ? launch<false, true>(tris, T, keys, n_keys, idx_mask,
                                         rays, n, t_out, idx_out, stream)
                   : launch<false, false>(tris, T, keys, n_keys, idx_mask,
                                          rays, n, t_out, idx_out, stream);
}
