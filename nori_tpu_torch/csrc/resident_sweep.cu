// K2 resident_sweep: closest-hit or any-hit ray/triangle sweep that
// walks each ray tile's sorted candidate keys and exits at the skyline.
// The same source builds K2-mxu (the matmul-form operand) and K4 (the
// mixed launch with a per-ray-tile any-hit flag).
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py
// `_mt_resident_kernel` (closest and any-hit forms, with the
// Baldwin-Weber `_bw_block` or the Moller-Trumbore `_mt_block` pair
// test; `use_mxu=True`, K2-mxu; `mixed=True`, K4), called through
// `_resident_call` / `mt_sweep_resident` / `mt_sweep_resident_mixed`.
//
// Contract: keys (n_rt, n_keys) int32, each row ascending, each key the
// tile's minimum entry distance bits with the tile index in the low
// idx_bits bits (ray_tile_entry_keys).  Output t (N,) float32 and idx
// (N,) int32, idx -1 on a miss.  Ties in t keep the lowest triangle
// index.  For any-hit only idx >= 0 is meaningful.  tile_ah, when not
// null, holds one int32 per ray tile: nonzero tiles take the any-hit
// exit, the others the closest one (K4).  visits, when not null,
// receives per ray tile the number of 128-triangle tiles it tested.
//
// Bound on the H100: arithmetic in the pair test (~40 flops BW, ~56
// MT, ~90 MXU) and, per visit, the block-wide skyline reduction.
// Design: one block per 256-ray tile, one thread per ray.  Each visited
// tile's 128 triangles (12, 9 or, for MXU, 10 x 4 x 128 weights: at
// most 20 KB) are staged in shared memory and every thread tests its
// ray against all of them, reading the same shared word as the rest of
// its warp (a broadcast).  After a visit the block recomputes t_hi, the
// largest useful t over its live rays, as an integer max of the float
// bits (all values >= 0, so the int order is the float order), and
// stops at the first key whose entry bits exceed it; keys are compared
// as integers, so a non-candidate key (inf or NaN bits) ends the walk.
// Any-hit stops once every live ray has a hit.  In the mixed launch the
// flag is read once per block, so both exit rules are block-uniform
// branches.  The whole operand stays in device memory (2.5 MB BW, 13 MB
// MXU for the 51.7k-triangle living room, resident in the 50 MB L2);
// the TPU's VMEM residency, SMEM key chunking (of the mixed launch
// too), key-row cap with its all-tiles fallback and visit width are not
// needed: one launch covers all rays with uncapped key rows and gives
// the same (t, idx).
//
// MXU form: the TPU multiplies ray features F = [o, d, o x d, 1] by the
// (10, 4 x 128) weight block of a tile on its matrix unit.  Here each
// thread forms its ray's 10 features and takes det, u_num, v_num and
// t_num as 10-term fp32 sums in feature order, on the FP32 units: TF32
// tensor cores keep ~3 digits and the hit test needs full fp32.
#include "common.cuh"

enum { OP_MT = 0, OP_BW = 1, OP_MXU = 2 };

template <int OP>
struct Rows { static constexpr int n = OP == OP_BW ? 12 : OP == OP_MT ? 9 : 10; };

template <int OP, bool ANY_HIT, bool MIXED>
__global__ void resident_sweep_kernel(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        const int* __restrict__ tile_ah, float* __restrict__ t_out,
        int* __restrict__ idx_out, int* __restrict__ visits) {
    constexpr int ROWS = Rows<OP>::n;
    constexpr int COLS = OP == OP_MXU ? 4 * FINE_T : FINE_T;
    __shared__ float s_tri[ROWS][COLS];
    __shared__ int s_red[TILE_N / 32];
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    const float dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    const bool live = mint <= maxt;
    // the exit rule of this block: uniform across it
    const bool ah = MIXED ? tile_ah[rt] != 0 : ANY_HIT;
    // MXU ray features [o, d, o x d, 1] (the TPU kernel's `feats`)
    const float f[10] = {ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                         oz * dx - ox * dz, ox * dy - oy * dx, 1.0f};

    float bt = __int_as_float(0x7f800000);  // +inf
    int bi = -1;
    int t_hi = block_max_int(t_cap_bits(live, bt, maxt), s_red);
    bool alive = __syncthreads_or(live) != 0;
    const int* row = keys + (size_t)rt * n_keys;
    int n_visits = 0;

    for (int k = 0; k < n_keys && alive; ++k) {
        const int key = row[k];
        if ((key & ~idx_mask) > t_hi) break;  // skyline: int compare
        const int j = key & idx_mask;
        // MXU: the tile's columns are contiguous [det | u | v | t] blocks
        const size_t col0 = (size_t)j * COLS;
        const size_t stride = OP == OP_MXU ? (size_t)4 * T : (size_t)T;
        for (int e = threadIdx.x; e < ROWS * COLS; e += TILE_N) {
            const int rr = e / COLS, cc = e - rr * COLS;
            s_tri[rr][cc] = tris[(size_t)rr * stride + col0 + cc];
        }
        __syncthreads();
        ++n_visits;
        if (live && !(ah && bi >= 0)) {
            const int base = j * FINE_T;
            for (int c = 0; c < FINE_T; ++c) {
                bool hit;
                float t;
                if constexpr (OP == OP_MXU) {
                    mxu_pair_test(&s_tri[0][0], c, f, mint, maxt, &hit, &t);
                } else {
                    pair_test<OP == OP_BW, FINE_T>(&s_tri[0][0], c, ox, oy,
                                                   oz, dx, dy, dz, mint, maxt,
                                                   &hit, &t);
                }
                if (hit && (t < bt || (t == bt && base + c < bi))) {
                    bt = t;
                    bi = base + c;
                }
            }
        }
        if (ah) {
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
    if (visits != nullptr && threadIdx.x == 0) visits[rt] = n_visits;
}

template <int OP>
static void launch_op(const float* tris, int T, const int* keys, int n_keys,
                      int idx_mask, const float* rays, int n, float* t_out,
                      int* idx_out, int any_hit, const int* tile_ah,
                      int* visits, cudaStream_t stream) {
#define LAUNCH(AH, MX)                                                      \
    resident_sweep_kernel<OP, AH, MX><<<n / TILE_N, TILE_N, 0, stream>>>(   \
        tris, T, keys, n_keys, idx_mask, rays, n, tile_ah, t_out, idx_out,  \
        visits)
    if (tile_ah != nullptr) LAUNCH(false, true);
    else if (any_hit) LAUNCH(true, false);
    else LAUNCH(false, false);
#undef LAUNCH
}

// op: 0 Moller-Trumbore (9, T), 1 Baldwin-Weber (12, T), 2 MXU (16, 4T);
// T is the triangle count in every case.
extern "C" int resident_sweep_launch(const float* tris, int op, int T,
                                     const int* keys, int n_keys,
                                     int idx_bits, const float* rays, int n,
                                     float* t_out, int* idx_out, int any_hit,
                                     const int* tile_ah, int* visits,
                                     cudaStream_t stream) {
    const int idx_mask = (1 << idx_bits) - 1;
    if (n >= TILE_N) {
        if (op == OP_BW) {
            launch_op<OP_BW>(tris, T, keys, n_keys, idx_mask, rays, n, t_out,
                             idx_out, any_hit, tile_ah, visits, stream);
        } else if (op == OP_MT) {
            launch_op<OP_MT>(tris, T, keys, n_keys, idx_mask, rays, n, t_out,
                             idx_out, any_hit, tile_ah, visits, stream);
        } else {
            launch_op<OP_MXU>(tris, T, keys, n_keys, idx_mask, rays, n, t_out,
                              idx_out, any_hit, tile_ah, visits, stream);
        }
    }
    return (int)cudaGetLastError();
}
