// K5 stream_sweep: closest-hit or any-hit ray/triangle sweep for
// soups too large for the resident layout, walking each ray tile's
// sorted candidate keys over 512-triangle slabs.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py
// `_mt_stream_kernel` (closest and any-hit forms, Baldwin-Weber or
// Moller-Trumbore operand; K5-cull for its `n_sub > 1`),
// called through `_stream_call` / `mt_sweep_streamed`.
//
// Contract: tris (16, T) float32, T a multiple of STREAM_T, rows
// [bw(12) | 0 x 4] (use_bw) or [v0 | e1 | e2 | 0 x 7]; keys (n_rt,
// n_keys) int32 from ray_tile_entry_keys on the (T / STREAM_T, 8) slab
// bounds, each row ascending, each key a slab's minimum entry distance
// bits with the slab index in the low idx_bits bits.  Output t (N,)
// float32 and idx (N,) int32, idx -1 on a miss; ties in t keep the
// lowest triangle index.  For any-hit only idx >= 0 is meaningful.
// sub_boxes holds (T / sub_t, 8) boxes [lo xyz | hi xyz | pad], one per
// sub_t consecutive triangles (sub_t a divisor of STREAM_T: STREAM_G
// from the scene, SceneData.tri_sub_boxes, or K5-cull's cull_t), an
// empty box (lo +inf, hi -inf) for padding triangles only.  visits,
// when not null, receives per ray tile the sub-blocks of STREAM_G
// triangles that its warps tested, summed over the 8 warps; tally, when
// not null, two counters to which every warp adds the sub-blocks it
// tested and those its gate skipped while one of its rays still
// searched.  The caller's workspace holds the per-ray packed best (N x
// 8 bytes), one record of 4 int32 per ray tile, three counters, and
// one pending count and one published skyline per ray tile.
//
// Bound on the H100: the pair tests' arithmetic (~40 flops BW, ~56
// MT, 512 per ray and visited slab).  The operand (26 MB of read rows
// for the 541,696-triangle ajax stand-in) stays in the 50 MB L2, and a
// staged quarter slab is 6 KB.  Measured on that scene (PERF.md): the
// rows are even (32,768 camera rays: 20.7 slabs per ray tile, p99 29;
// one whitted batch's sorted shadow rays: 23.6, max 51), but one block
// of 8 warps alone on its SM takes ~190 us per 512-triangle visit, a
// fifth of the SM's issue rate, because the pair test is one dependent
// chain; with 128 ray tiles on 132 SMs every block runs so.  A closest
// walk prunes as it goes (65 candidate keys per row, 20.7 visited), so
// the keys of a row must stay in order; any-hit visits every candidate.
//
// Design: two launches, with no host read between them.
// * Plan, one block per 256-ray tile: the keys that pass the skyline of
//   the rays' maxt (a prefix, since rows ascend) are cut into chunks of
//   STREAM_S keys; a ray tile with none writes its misses.  Each chunk
//   is STREAM_T / STREAM_U work items, one per quarter of the slabs.
// * Sweep, a fixed grid of persistent blocks (as many as the SMs hold
//   at once) that pull item numbers from one counter.  The numbers run
//   chunk-major: all ray tiles' first chunks, then all second chunks,
//   so a row's keys are taken nearly in order while the card works on
//   every row at once, four quarters each.  An item loads its rays,
//   starts each from the packed best in the workspace (an upper bound
//   of the final best, so pruning with it stays exact), stages its
//   quarter of each slab (12 or 9 rows x 128 triangles) by cp.async
//   into a double buffer, the copy of the next key overlapping the test
//   of this one, tests with the pair loop unrolled x8 (independent
//   tests interleave, the fold stays in index order), and recomputes
//   the skyline after every quarter; one __syncthreads publishes it,
//   lands the next copy and frees the tested buffer.  A copy is issued
//   only for a key that still passes the skyline, since t_hi never
//   rises.  The item folds its hits into the packed best with a 64-bit
//   atomicMin, whose order is the fold's (smallest t, then lowest
//   index), so any order of items gives the same answer; it does so
//   after every quarter and takes over a better word it finds there
//   (share_best), so the four quarters of a chunk prune with each
//   other's hits and an any-hit ray stops in all four once one has hit.
//   The item that takes a ray tile's last pending count writes its t and
//   idx.
// This takes the place of the TPU kernel's sequential grid over ray
// chunks with capped key rows and an overflow fallback: one pair of
// launches covers all rays with uncapped keys.
//
// The gate: after a quarter lands, each warp tests its sub-blocks of
// STREAM_G triangles only if one of its 32 rays, still searching, may
// hit a triangle of it within its useful t (min(bt, maxt) inclusive
// for closest, maxt for any-hit): a slab test per ray against the
// widened boxes that cover the sub-block (gate_box) and one __any_sync;
// the warps do not wait for each other, and the block keeps its one
// barrier a quarter.  bt starts from the packed best, an upper bound of
// the final one, and a skipped sub-block holds no triangle the pair
// test would accept in time, so the answer equals the dense sweep's.
// K5-cull is the same walk on the Moller-Trumbore operand, gated by its
// own sub-blocks' boxes.
#include "common.cuh"

#define STREAM_Q (STREAM_T / STREAM_U)  // work items per chunk of keys

template <bool BW>
struct StreamSmem {
    static constexpr int rows = BW ? 12 : 9;
    __align__(16) float tri[2][rows * STREAM_U];
    Skyline sky;
};

// What a walk counts: the triangle groups its warps tested and, for the
// tally, the groups its warps' gates skipped while a ray searched.
struct WalkCount {
    int tested = 0, culled = 0;
};

// Walks quarter q of the slabs of keys row[k0 .. k1) of one ray tile,
// from each thread's best (bt, bi) and the block's skyline (t_hi,
// alive), which it updates; each warp adds to *n the sub-blocks of
// STREAM_G triangles it tested and (with `tally`) those its gate
// skipped.  The gate reads the boxes of each sub_t triangles (sub_t a
// divisor of STREAM_T).  Every branch on t_hi, alive and k is uniform
// across the block, every branch on a gate across the warp.
template <bool BW>
__device__ void stream_walk(StreamSmem<BW>& sm, const float* tris, int T,
                            const int* row, int k0, int k1, int q,
                            int idx_mask, const Ray& y, bool live, bool ah,
                            int sub_t, const float* sub_boxes, bool tally,
                            unsigned long long* best_r,
                            unsigned long long& known, float& bt, int& bi,
                            int& t_hi, bool& alive, WalkCount* n) {
    constexpr int ROWS = StreamSmem<BW>::rows;
    auto passes = [&](int k) { return (row[k] & ~idx_mask) <= t_hi; };
    auto stage = [&](int k, int slot) {
        const int j = row[k] & idx_mask;
        stage_rows<ROWS, STREAM_U>(
            tris + (size_t)j * STREAM_T + q * STREAM_U, (size_t)T,
            sm.tri[slot]);
    };
    const float ix = safe_inv(y.dx), iy = safe_inv(y.dy), iz = safe_inv(y.dz);
    const float o_mag =
        fmaxf(fmaxf(fabsf(y.ox), fabsf(y.oy)), fabsf(y.oz));
    int k = k0, nv = 0;
    if (!(alive && k < k1 && passes(k))) return;
    stage(k, 0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (;;) {
        // key k's quarter has landed in buffer nv & 1; stage the next
        // key now unless it already fails the skyline
        const int j = row[k] & idx_mask;
        const bool next = k + 1 < k1 && passes(k + 1);
        if (next) stage(k + 1, (nv + 1) & 1);
        const float* tile = sm.tri[nv & 1];
        ++nv;
        const int base = j * STREAM_T + q * STREAM_U;
        for (int c0 = 0; c0 < STREAM_U; c0 += STREAM_G) {
            // the warp tests the sub-block if one of its rays, still
            // searching, may hit a triangle of it within its useful t
            const bool need = needs(live, ah, bi);
            bool want = false;
            if (need) {
                const float tu = ah ? y.maxt : fminf(bt, y.maxt);
                const int b1 = (base + c0 + STREAM_G - 1) / sub_t;
                for (int b = (base + c0) / sub_t; b <= b1 && !want; ++b) {
                    want = gate_box(sub_boxes + (size_t)b * 8, y.ox, y.oy,
                                    y.oz, ix, iy, iz, o_mag, y.mint, tu);
                }
            }
            if (!__any_sync(0xffffffffu, want)) {
                if (tally && __any_sync(0xffffffffu, need)) ++n->culled;
                continue;
            }
            ++n->tested;
            if (need) {
                // independent pair tests interleave; the fold stays in order
#pragma unroll 8
                for (int c = c0; c < c0 + STREAM_G; ++c) {
                    bool hit;
                    float t;
                    pair_test<BW, STREAM_U>(tile, c, y.ox, y.oy, y.oz, y.dx,
                                            y.dy, y.dz, y.mint, y.maxt, &hit,
                                            &t);
                    if (hit && (t < bt || (t == bt && base + c < bi))) {
                        bt = t;
                        bi = base + c;
                    }
                }
            }
        }
        share_best(best_r, known, bt, bi);
        // one barrier: publishes the skyline, lands the next quarter and
        // frees this one for the copy after next
        skyline_partials(sm.sky, nv & 1, needs(live, ah, bi), bt, y.maxt);
        __pipeline_wait_prior(0);
        __syncthreads();
        skyline_read(sm.sky, nv & 1, ah, &t_hi, &alive);
        ++k;
        if (!(alive && next && passes(k))) break;
    }
}

template <bool ANY_HIT>
__global__ void stream_plan(const int* __restrict__ keys, int n_keys,
                            int idx_mask, const float* __restrict__ rays,
                            int n, float* __restrict__ t_out,
                            int* __restrict__ idx_out,
                            int* __restrict__ visits, Work w) {
    __shared__ Skyline sky;
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    int t_hi;
    bool alive;
    skyline_start(sky, mint <= maxt, ANY_HIT, __int_as_float(0x7f800000), -1,
                  maxt, &t_hi, &alive);
    // the keys that pass the skyline: a prefix, since rows ascend
    const int* row = keys + (size_t)rt * n_keys;
    const int k_end = !alive ? 0 : prefix_length(n_keys, [&](int k) {
        return (row[k] & ~idx_mask) <= t_hi;
    });
    if (visits != nullptr && threadIdx.x == 0) visits[rt] = 0;
    if (k_end == 0) {
        t_out[r] = __int_as_float(0x7f800000);
        idx_out[r] = -1;
        return;
    }
    w.best[r] = PACKED_MISS;
    if (threadIdx.x == 0) push_record(w, rt, k_end, STREAM_S, STREAM_Q, t_hi);
}

template <bool BW, bool ANY_HIT>
__global__ void stream_sweep_items(
        const float* __restrict__ tris, int T, const int* __restrict__ keys,
        int n_keys, int idx_mask, const float* __restrict__ rays, int n,
        int sub_t, const float* __restrict__ sub_boxes,
        float* __restrict__ t_out, int* __restrict__ idx_out,
        int* __restrict__ visits, unsigned long long* __restrict__ tally,
        Work w) {
    __shared__ StreamSmem<BW> sm;
    __shared__ ItemSlot slot;
    // an item whose first key lies beyond the ray tile's published
    // skyline is shut
    auto shut = [&](int rt, int k0, int hi) {
        return (keys[(size_t)rt * n_keys + k0] & ~idx_mask) > hi;
    };
    int4 it;
    while (pull_item(w, STREAM_S, STREAM_Q, slot, shut, &it)) {
        const int rt = it.x;
        const int r = rt * TILE_N + threadIdx.x;
        if (!(it.w & ITEM_SHUT)) {
            const Ray y = load_ray(rays, n, r);
            const bool live = y.mint <= y.maxt;
            unsigned long long known = __ldcg(&w.best[r]);
            float bt;
            int bi, t_hi;
            bool alive;
            WalkCount nc;
            unpack_best(known, &bt, &bi);
            skyline_start(sm.sky, live, ANY_HIT, bt, bi, y.maxt, &t_hi,
                          &alive);
            stream_walk<BW>(sm, tris, T, keys + (size_t)rt * n_keys, it.y,
                            it.z, it.w, idx_mask, y, live, ANY_HIT, sub_t,
                            sub_boxes, tally != nullptr, &w.best[r], known,
                            bt, bi, t_hi, alive, &nc);
            const unsigned long long p = pack_best(bt, bi);
            if (p < known) atomicMin(&w.best[r], p);
            if (threadIdx.x == 0) atomicMin(&w.row_hi[rt], alive ? t_hi : -1);
            // each warp's counts, the same in all its lanes
            if ((threadIdx.x & 31) == 0) {
                if (visits != nullptr && nc.tested > 0) {
                    atomicAdd(&visits[rt], nc.tested);
                }
                if (tally != nullptr && nc.tested > 0) {
                    atomicAdd(&tally[0], (unsigned long long)nc.tested);
                }
                if (tally != nullptr && nc.culled > 0) {
                    atomicAdd(&tally[1], (unsigned long long)nc.culled);
                }
            }
        }
        // the last item of a ray tile writes its rays' answers
        if (last_item(w, rt, slot)) {
            float bt;
            int bi;
            unpack_best(atomicAdd(&w.best[r], 0ull), &bt, &bi);
            t_out[r] = bt;
            idx_out[r] = bi;
        }
    }
}

template <bool BW, bool AH>
static int launch(const float* tris, int T, const int* keys, int n_keys,
                  int idx_mask, const float* rays, int n, int sub_t,
                  const float* sub_boxes, float* t_out, int* idx_out,
                  int* visits, unsigned long long* tally, Work w,
                  cudaStream_t stream) {
    const int n_rt = n / TILE_N;
    cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    stream_plan<AH><<<n_rt, TILE_N, 0, stream>>>(
        keys, n_keys, idx_mask, rays, n, t_out, idx_out, visits, w);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_keys == 0) return (int)err;
    // the sweep runs whatever the plan left, without a host read of the
    // counts: as many blocks as the card holds at once, but no more
    // than the items there can be
    static int resident = 0;
    if (resident == 0) {
        resident = resident_blocks(stream_sweep_items<BW, AH>, TILE_N);
    }
    const long long cap = (long long)n_rt * STREAM_Q *
                          ((n_keys + STREAM_S - 1) / STREAM_S);
    const int grid = resident < cap ? resident : (int)cap;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    stream_sweep_items<BW, AH><<<grid, TILE_N, 0, stream>>>(
        tris, T, keys, n_keys, idx_mask, rays, n, sub_t, sub_boxes, t_out,
        idx_out, visits, tally, w);
    return (int)cudaGetLastError();
}

// sub_boxes: (T / sub_t, 8) float32, 16-byte aligned; tally: 2 uint64 or
// null; best: (N,) uint64; items: (n_rt, 4) int32; counters: 3 int32;
// pending: (2 n_rt,) int32 (the pending counts, then the published
// skylines); none of the scratch needs initialising.
extern "C" int stream_sweep_launch(const float* tris, int use_bw, int T,
                                   const int* keys, int n_keys, int idx_bits,
                                   const float* rays, int n, float* t_out,
                                   int* idx_out, int any_hit, int sub_t,
                                   const float* sub_boxes, int* visits,
                                   unsigned long long* tally,
                                   unsigned long long* best, int* items,
                                   int* counters, int* pending,
                                   cudaStream_t stream) {
    const int idx_mask = (1 << idx_bits) - 1;
    if (n < TILE_N || sub_t < 1 || STREAM_T % sub_t || sub_boxes == nullptr)
        return (int)cudaErrorInvalidValue;
    const Work w{best, reinterpret_cast<int4*>(items), counters, pending,
                 pending + n / TILE_N};
#define ARGS tris, T, keys, n_keys, idx_mask, rays, n, sub_t, sub_boxes, \
             t_out, idx_out, visits, tally, w, stream
    if (use_bw) {
        return any_hit ? launch<true, true>(ARGS) : launch<true, false>(ARGS);
    }
    return any_hit ? launch<false, true>(ARGS) : launch<false, false>(ARGS);
#undef ARGS
}
