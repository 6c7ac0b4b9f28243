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
// receives per ray tile the number of 128-triangle tiles it tested, in
// both passes.  The caller's workspace holds the per-ray packed best
// (N x 8 bytes), the work list (n_rt x ceil(n_keys / RESIDENT_S) items
// of 4 int32), two counters and one pending count per ray tile.
//
// Bound on the H100: arithmetic in the pair test (~40 flops BW, ~56
// MT, ~90 MXU), but only if the walks spread over the card.  One block
// (one thread per ray) tests a 128-triangle tile in 10-20 us when it
// runs alone on its SM, and a row is long when one of its rays escapes
// or hits far: such a ray holds the tile's skyline open over nearly
// every candidate.  On the living room the visits per ray tile have a
// median of 2 (closest) and 12 (any-hit) but a maximum of 271 of 404
// tiles, and a one-pass walk ends with its longest rows on a few SMs
// while the others idle (PERF.md).
//
// Design: two launches, with no host read between them.
// * First pass, one block per 256-ray tile.  Each visited tile's 128
//   triangles (12, 9 or, for MXU, 10 x 4 x 128 weights: at most 20 KB)
//   are staged in shared memory by cp.async into a double buffer: the
//   copy of key k+1 is issued before the test of key k.  Every thread
//   tests its ray against the staged tile, reading the same shared word
//   as the rest of its warp (a broadcast).  After a visit the block
//   recomputes the skyline t_hi, the largest useful t over its rays
//   still searching, as an integer max of the float bits (all values
//   >= 0), and stops at the first key whose entry bits exceed it; keys
//   compare as integers, so a non-candidate key (inf or NaN bits) ends
//   the walk.  Any-hit stops once every live ray has a hit.  The
//   reduction, the landing of the next copy and the release of the
//   tested buffer share one __syncthreads per visit.  A walk stops
//   after RESIDENT_V visits; if keys that pass the skyline remain, the
//   block stores its rays' best hits as packed words and pushes the
//   rest of its row as items of RESIDENT_S keys (one atomicAdd).
// * Tail pass, a fixed grid of persistent blocks (as many as the SMs
//   hold at once) that pull items until the list is empty; with no
//   items it costs each block one atomic.  An item loads its ray tile's
//   rays, starts from the packed best of each ray (an upper bound of
//   the final best, so pruning with it stays exact), walks its keys
//   with the same skyline or any-hit exit, and folds its hits with a
//   64-bit atomicMin.  The packed word orders as the fold does: the
//   smallest t, then the lowest index, whatever the order of the items.
//   The item that finishes a ray tile's last pending count writes its
//   t and idx.
// This is the Hopper counterpart of the TPU kernel's capped key rows
// with their exact all-tiles fallback (pallas_mt.py:487-520): there a
// row past its cap was finished by one sweep over every tile, here the
// rest of a long row is spread over the card.  The operand stays in
// device memory (2.5 MB BW, 13 MB MXU for the 51.7k-triangle living
// room, resident in the 50 MB L2); the TPU's VMEM residency, SMEM key
// chunking (of the mixed launch too) and visit width are not needed.
//
// MXU form: the TPU multiplies ray features F = [o, d, o x d, 1] by the
// (10, 4 x 128) weight block of a tile on its matrix unit.  Here each
// thread forms its ray's 10 features and takes det, u_num, v_num and
// t_num as 10-term fp32 sums in feature order, on the FP32 units: TF32
// tensor cores keep ~3 digits and the hit test needs full fp32.
#include "common.cuh"

enum { OP_MT = 0, OP_BW = 1, OP_MXU = 2 };

template <int OP>
struct Op {
    static constexpr int rows = OP == OP_BW ? 12 : OP == OP_MT ? 9 : 10;
    static constexpr int cols = OP == OP_MXU ? 4 * FINE_T : FINE_T;
    static constexpr int tile = rows * cols;  // floats staged per visit
};

// Shared memory of both passes: the staging double buffer and the
// skyline reduction's slots, two sets used in turn, so one barrier per
// reduction suffices.
template <int OP>
struct Smem {
    __align__(16) float tri[2][Op<OP>::tile];
    Skyline sky;
};

// This thread's share of the copy of tile j into dst (one commit group).
template <int OP>
__device__ __forceinline__ void stage(const float* tris, size_t stride,
                                      int j, float* dst) {
    stage_rows<Op<OP>::rows, Op<OP>::cols>(
        tris + (size_t)j * Op<OP>::cols, stride, dst);
}

// Walks keys row[k0 .. k1) of one ray tile, at most vmax visits, from
// each thread's best (bt, bi) and the block's skyline (t_hi, alive),
// which it updates.  Returns the first key it did not visit; adds its
// visits to *n_visits.  Every branch on t_hi, alive, k and the visit
// count is uniform across the block.
template <int OP>
__device__ int walk(Smem<OP>& sm, const float* tris, int T, const int* row,
                    int k0, int k1, int vmax, int idx_mask, const Ray& y,
                    bool live, bool ah, float& bt, int& bi, int& t_hi,
                    bool& alive, int* n_visits) {
    const size_t stride = OP == OP_MXU ? (size_t)4 * T : (size_t)T;
    auto passes = [&](int k) { return (row[k] & ~idx_mask) <= t_hi; };
    int k = k0, nv = 0;
    if (!(alive && k < k1 && vmax > 0 && passes(k))) return k;
    stage<OP>(tris, stride, row[k] & idx_mask, sm.tri[0]);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (;;) {
        // tile row[k] has landed in buffer nv & 1; stage the next key
        // now unless it already fails the skyline (t_hi never rises)
        const int j = row[k] & idx_mask;
        const bool next = k + 1 < k1 && nv + 1 < vmax && passes(k + 1);
        if (next) {
            stage<OP>(tris, stride, row[k + 1] & idx_mask,
                      sm.tri[(nv + 1) & 1]);
        }
        const float* tile = sm.tri[nv & 1];
        ++nv;
        if (needs(live, ah, bi)) {
            const int base = j * FINE_T;
            // independent pair tests interleave; the fold stays in order
#pragma unroll 8
            for (int c = 0; c < FINE_T; ++c) {
                bool hit;
                float t;
                if constexpr (OP == OP_MXU) {
                    mxu_pair_test(tile, c, y.f, y.mint, y.maxt, &hit, &t);
                } else {
                    pair_test<OP == OP_BW, FINE_T>(tile, c, y.ox, y.oy, y.oz,
                                                   y.dx, y.dy, y.dz, y.mint,
                                                   y.maxt, &hit, &t);
                }
                if (hit && (t < bt || (t == bt && base + c < bi))) {
                    bt = t;
                    bi = base + c;
                }
            }
        }
        // one barrier: publishes the skyline, lands the next tile and
        // frees this one for the copy after next
        skyline_partials(sm.sky, nv & 1, needs(live, ah, bi), bt, y.maxt);
        __pipeline_wait_prior(0);
        __syncthreads();
        skyline_read(sm.sky, nv & 1, ah, &t_hi, &alive);
        ++k;
        if (!(alive && next && passes(k))) break;
    }
    *n_visits += nv;
    return k;
}

template <int OP, bool ANY_HIT, bool MIXED>
__global__ void resident_first_pass(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        const int* __restrict__ tile_ah, float* __restrict__ t_out,
        int* __restrict__ idx_out, int* __restrict__ visits, Work w) {
    __shared__ Smem<OP> sm;
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const Ray y = load_ray(rays, n, r);
    const bool live = y.mint <= y.maxt;
    // the exit rule of this block: uniform across it
    const bool ah = MIXED ? tile_ah[rt] != 0 : ANY_HIT;
    float bt = __int_as_float(0x7f800000);  // +inf
    int bi = -1, t_hi, n_visits = 0;
    bool alive;
    skyline_start(sm.sky, live, ah, bt, bi, y.maxt, &t_hi, &alive);
    const int* row = keys + (size_t)rt * n_keys;
    const int k = walk(sm, tris, T, row, 0, n_keys, RESIDENT_V, idx_mask, y,
                       live, ah, bt, bi, t_hi, alive, &n_visits);
    if (visits != nullptr && threadIdx.x == 0) visits[rt] = n_visits;
    const bool spill = n_visits == RESIDENT_V && alive && k < n_keys &&
                       (row[k] & ~idx_mask) <= t_hi;
    if (!spill) {
        t_out[r] = bt;
        idx_out[r] = bi;
        return;
    }
    // the keys left that pass the skyline: a prefix, since rows ascend
    int k_end = k;
    for (int k0 = k; k0 < n_keys; k0 += TILE_N) {
        const int e = k0 + threadIdx.x;
        const int c = __syncthreads_count(
            e < n_keys && (row[e] & ~idx_mask) <= t_hi);
        k_end += c;
        if (c < TILE_N) break;
    }
    w.best[r] = pack_best(bt, bi);
    if (threadIdx.x == 0) {
        const int n_items = (k_end - k + RESIDENT_S - 1) / RESIDENT_S;
        const int at = atomicAdd(&w.counters[0], n_items);
        w.pending[rt] = n_items;
        for (int i = 0; i < n_items; ++i) {
            const int a = k + i * RESIDENT_S;
            w.items[at + i] = make_int4(rt, a, min(a + RESIDENT_S, k_end),
                                        ah ? 1 : 0);
        }
    }
}

template <int OP, bool ANY_HIT, bool MIXED>
__global__ void resident_tail_pass(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        float* __restrict__ t_out, int* __restrict__ idx_out,
        int* __restrict__ visits, Work w) {
    __shared__ Smem<OP> sm;
    __shared__ ItemSlot slot;
    for (;;) {
        if (threadIdx.x == 0) {
            const int i = atomicAdd(&w.counters[1], 1);
            slot.item =
                i < w.counters[0] ? w.items[i] : make_int4(-1, 0, 0, 0);
        }
        __syncthreads();
        const int4 it = slot.item;
        if (it.x < 0) return;  // the list is empty
        const int rt = it.x;
        const int r = rt * TILE_N + threadIdx.x;
        const Ray y = load_ray(rays, n, r);
        const bool live = y.mint <= y.maxt;
        // the flag travels with the item
        const bool ah = MIXED ? it.w != 0 : ANY_HIT;
        const unsigned long long p0 = __ldcg(&w.best[r]);
        float bt;
        int bi, t_hi, n_visits = 0;
        bool alive;
        unpack_best(p0, &bt, &bi);
        skyline_start(sm.sky, live, ah, bt, bi, y.maxt, &t_hi, &alive);
        walk(sm, tris, T, keys + (size_t)rt * n_keys, it.y, it.z,
             it.z - it.y, idx_mask, y, live, ah, bt, bi, t_hi, alive,
             &n_visits);
        const unsigned long long p = pack_best(bt, bi);
        if (p < p0) atomicMin(&w.best[r], p);
        if (visits != nullptr && threadIdx.x == 0) {
            atomicAdd(&visits[rt], n_visits);
        }
        // the last item of a ray tile writes its rays' answers
        if (last_item(w, rt, slot)) {
            unpack_best(atomicAdd(&w.best[r], 0ull), &bt, &bi);
            t_out[r] = bt;
            idx_out[r] = bi;
        }
    }
}

// Resident blocks of the tail pass: as many as the card holds at once.
template <int OP, bool AH, bool MX>
static int tail_grid() {
    static int grid = 0;
    if (grid == 0) {
        grid = resident_blocks(resident_tail_pass<OP, AH, MX>, TILE_N);
    }
    return grid;
}

template <int OP, bool AH, bool MX>
static int launch(const float* tris, int T, const int* keys, int n_keys,
                  int idx_mask, const float* rays, int n, float* t_out,
                  int* idx_out, const int* tile_ah, int* visits, Work w,
                  cudaStream_t stream) {
    const int n_rt = n / TILE_N;
    cudaError_t err = cudaMemsetAsync(w.counters, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    resident_first_pass<OP, AH, MX><<<n_rt, TILE_N, 0, stream>>>(
        tris, T, keys, n_keys, idx_mask, rays, n, tile_ah, t_out, idx_out,
        visits, w);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_keys <= RESIDENT_V) return (int)err;
    // the tail pass runs whatever the first one pushed, without a host
    // read of the count; no more blocks than items the list can hold
    const int cap = n_rt * ((n_keys + RESIDENT_S - 1) / RESIDENT_S);
    const int resident = tail_grid<OP, AH, MX>();
    const int grid = resident < cap ? resident : cap;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    resident_tail_pass<OP, AH, MX><<<grid, TILE_N, 0, stream>>>(
        tris, T, keys, n_keys, idx_mask, rays, n, t_out, idx_out, visits, w);
    return (int)cudaGetLastError();
}

template <int OP>
static int launch_op(const float* tris, int T, const int* keys, int n_keys,
                     int idx_mask, const float* rays, int n, float* t_out,
                     int* idx_out, int any_hit, const int* tile_ah,
                     int* visits, Work w, cudaStream_t stream) {
#define ARGS tris, T, keys, n_keys, idx_mask, rays, n, t_out, idx_out, \
             tile_ah, visits, w, stream
    if (tile_ah != nullptr) return launch<OP, false, true>(ARGS);
    if (any_hit) return launch<OP, true, false>(ARGS);
    return launch<OP, false, false>(ARGS);
#undef ARGS
}

// op: 0 Moller-Trumbore (9, T), 1 Baldwin-Weber (12, T), 2 MXU (16, 4T);
// T is the triangle count in every case.  best: (N,) uint64; items:
// (n_rt * ceil(n_keys / RESIDENT_S), 4) int32; counters: 2 int32;
// pending: (n_rt,) int32; none needs initialising.
extern "C" int resident_sweep_launch(const float* tris, int op, int T,
                                     const int* keys, int n_keys,
                                     int idx_bits, const float* rays, int n,
                                     float* t_out, int* idx_out, int any_hit,
                                     const int* tile_ah, int* visits,
                                     unsigned long long* best, int* items,
                                     int* counters, int* pending,
                                     cudaStream_t stream) {
    const int idx_mask = (1 << idx_bits) - 1;
    if (n < TILE_N) return (int)cudaGetLastError();
    const Work w{best, reinterpret_cast<int4*>(items), counters, pending};
#define ARGS tris, T, keys, n_keys, idx_mask, rays, n, t_out, idx_out, \
             any_hit, tile_ah, visits, w, stream
    if (op == OP_BW) return launch_op<OP_BW>(ARGS);
    if (op == OP_MT) return launch_op<OP_MT>(ARGS);
    return launch_op<OP_MXU>(ARGS);
#undef ARGS
}
