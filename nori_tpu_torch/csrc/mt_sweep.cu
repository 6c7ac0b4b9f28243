// K6 mt_sweep: the 2-D culled Moller-Trumbore sweep with barycentrics.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py `_mt_kernel`,
// called through `mt_sweep` (a 2-D grid of (ray tile, 512-triangle
// tile) steps; the second axis runs in order and carries the closest
// hit in scratch).
//
// Contract: tris (9, T) [v0 | e1 | e2], T a multiple of TILE_T = 512;
// order (n_rt, n_tt) int32, each row a permutation of the n_tt
// 512-triangle tiles (near to far); entry (n_rt, n_tt) float32, the
// ray tile's minimum entry distance into each tile's box (K1 on the
// coarsened bounds), ascending along its order row; bounds (n_tt, 8)
// those boxes; scene (8,) [centre xyz | half diagonal | ...].  Outputs
// t, idx, u, v, each (N,): the closest hit with its raw barycentrics,
// idx -1 and t +inf on a miss.  Within a tile ties keep the lowest
// index, across tiles the tile earlier in the ray tile's order (the TPU
// kernel's fold: its earlier visit).  For any-hit only idx >= 0 is
// meaningful.  visits, when not null, receives per ray tile the number
// of quarter tiles (TILE_U triangles) it tested.  The caller's
// workspace is K5's (stream_sweep.cu).
//
// With cull, a tile is tested only if it overlaps the block's reach
// (the box spanned by the origins and directions of its rays still
// searching, up to t_hi, the largest min(bt, maxt, distance to the
// scene's bounding sphere) among them) and its entry bound does not
// exceed t_hi (pallas_mt.py:104-151).  The test is conservative, so
// culling skips only tiles that cannot hold a closer hit.
//
// Bound on the H100: the pair tests' arithmetic (~56 flops, 512 per
// ray and tested tile).  Measured on the living room's 131,072 check
// rays (PERF.md): a ray tile tests 4.75 of 101 tiles in the mean but up
// to 87, a block alone on its SM takes ~90 us per tile, and a one-pass
// walk reduced the reach (14 values, two barriers) for all 101 tiles,
// tested or not.
//
// Design: K5's two launches (stream_sweep.cu).  The plan cuts the
// positions of a ray tile's order row whose entry bound passes its
// first skyline (a prefix: the row ascends) into chunks of MT_S
// positions, each TILE_T / TILE_U work items, one per quarter of the
// tiles.  The persistent blocks of the sweep pull item numbers
// chunk-major.  An item starts its rays from the packed best (and
// shares it after every quarter, share_best), reduces its reach once,
// and scans its positions with two compares and a box overlap per
// tile, which every thread evaluates alike from the reduced reach: no
// reduction and no barrier for a tile it skips, and the scan stops at
// the first entry bound beyond t_hi.  It stages the quarter of the next
// tile that passes (9 rows x 128 triangles) by cp.async while it tests
// this one, then reduces the reach again (one barrier, which also lands
// the copy); if the smaller reach now skips the staged tile, the next
// one that passes is staged in its place.
// An item's best holds real hits only, so its reach never skips a tile
// that could hold a closer hit.  It may test tiles the one-pass walk
// skipped (where items run out of order its best is an upper bound of
// that walk's), and skip tiles that walk tested (where another item ran
// ahead and found a hit the walk would only have found later).
//
// The fold across items goes through the packed word, ordered by t,
// then the tile's position in the ray tile's order, then the index in
// the tile: within one walk positions only grow, so this is the
// one-pass fold (strict t, lowest lane, earlier visit) whatever the
// order of the items.  u and v do not fit the word: the item that takes
// a ray tile's last pending count recomputes them for the winner with
// the same pair test on the operand in device memory; the same
// expression without FMA contraction gives the same bits.
#include "common.cuh"

#define TILE_T 512  // triangles per tile of the 2-D sweep
#define TILE_Q (TILE_T / TILE_U)  // work items per chunk of positions

constexpr int N_RED = 14;  // t_hi, any need, 3 x (o_lo, o_hi, d_lo, d_hi)

struct MtSmem {
    __align__(16) float tri[2][9 * TILE_U];
    float red[2][NW * N_RED];  // two slot sets, used in turn
};

// What a block's rays still searching can reach.
struct Reach {
    float t_hi;  // >= 0
    bool any;    // does any ray still search?
    float lo[3], hi[3];
};

// The warps' partial reach (slot 0 and 1 maxima, then per axis min,
// max, min, max) into slot set s; the caller's next __syncthreads
// publishes it.  far: the ray's distance to the far side of the scene's
// bounding sphere.
__device__ __forceinline__ void reach_partials(float* s, bool need, float bt,
                                               const Ray& y, float far) {
    const float big = 3e37f;
    float v[N_RED];
    v[0] = need ? fminf(fminf(bt, y.maxt), far) : 0.0f;
    v[1] = need ? 1.0f : 0.0f;
    const float oc[3] = {y.ox, y.oy, y.oz}, dc[3] = {y.dx, y.dy, y.dz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        v[2 + 4 * a] = need ? oc[a] : big;
        v[3 + 4 * a] = need ? oc[a] : -big;
        v[4 + 4 * a] = need ? dc[a] : 0.0f;
        v[5 + 4 * a] = need ? dc[a] : 0.0f;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < N_RED; ++i) {
        const bool is_max = i < 2 || ((i - 2) & 1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
            v[i] = is_max ? fmaxf(v[i], o) : fminf(v[i], o);
        }
        if (lane == 0) s[warp * N_RED + i] = v[i];
    }
}

// After the barrier: the block's reach, the same in every thread.
__device__ __forceinline__ Reach reach_read(const float* s) {
    float v[N_RED];
#pragma unroll
    for (int i = 0; i < N_RED; ++i) {
        const bool is_max = i < 2 || ((i - 2) & 1);
        float m = s[i];
        for (int w = 1; w < NW; ++w) {
            m = is_max ? fmaxf(m, s[w * N_RED + i]) : fminf(m, s[w * N_RED + i]);
        }
        v[i] = m;
    }
    Reach R;
    R.t_hi = fmaxf(v[0], 0.0f);
    R.any = v[1] > 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        R.lo[a] = v[2 + 4 * a] + R.t_hi * fminf(v[4 + 4 * a], 0.0f);
        R.hi[a] = v[3 + 4 * a] + R.t_hi * fmaxf(v[5 + 4 * a], 0.0f);
    }
    return R;
}

// The skyline a ray tile publishes for the pulls of its later items:
// t_hi's bits (t_hi >= 0, so they order as ints), -1 once no ray
// searches.
__device__ __forceinline__ int reach_bits(const Reach& R) {
    return R.any ? __float_as_int(R.t_hi) : -1;
}

// The ray's distance to the far side of the scene's bounding sphere.
__device__ __forceinline__ float far_side(const Ray& y, const float* scene) {
    const float ex = y.ox - scene[0], ey = y.oy - scene[1],
                ez = y.oz - scene[2];
    return sqrtf(ex * ex + ey * ey + ez * ez) + scene[3];
}

// Walks quarter q of the tiles at positions [j0, j1) of one ray tile's
// order row, from each thread's best (bt, bkey; bkey = position x
// TILE_T + index in the tile) and the block's reach R, which it
// updates; adds the quarters it tested to *n_visits.  Every branch on
// R and the positions is uniform across the block.
template <bool CULL, bool ANY_HIT>
__device__ void mt_walk(MtSmem& sm, const float* tris, int T, const int* ord,
                        const float* ent, const float* bounds, int j0, int j1,
                        int q, const Ray& y, bool live, float far,
                        unsigned long long* best_r, unsigned long long& known,
                        float& bt, int& bkey, Reach& R, int* n_visits) {
    // the first position >= p to test under the reach R, or j1
    auto next_pass = [&](int p) {
        if (!R.any) return j1;
        for (; p < j1; ++p) {
            if (!CULL) return p;
            const int jj = ord[p];
            if (!(ent[jj] <= R.t_hi)) return j1;  // and so are all later
            const float* b = bounds + (size_t)jj * 8;
            bool overlap = true;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                overlap = overlap && R.hi[a] >= b[a] && R.lo[a] <= b[3 + a];
            }
            if (overlap) return p;
        }
        return j1;
    };
    auto stage = [&](int p, int slot) {
        stage_rows<9, TILE_U>(
            tris + (size_t)ord[p] * TILE_T + q * TILE_U, (size_t)T,
            sm.tri[slot]);
    };
    int j = next_pass(j0), nv = 0;
    if (j >= j1) return;
    stage(j, 0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (;;) {
        // position j's quarter has landed in buffer nv & 1; stage the
        // next position that passes the reach as it is now
        const int staged = next_pass(j + 1);
        if (staged < j1) stage(staged, (nv + 1) & 1);
        const float* tile = sm.tri[nv & 1];
        ++nv;
        if (needs(live, ANY_HIT, bkey)) {
            const int base = j * TILE_T + q * TILE_U;
#pragma unroll 8
            for (int c = 0; c < TILE_U; ++c) {
                bool hit;
                float t;
                pair_test<false, TILE_U>(tile, c, y.ox, y.oy, y.oz, y.dx,
                                         y.dy, y.dz, y.mint, y.maxt, &hit, &t);
                if (hit && (t < bt || (t == bt && base + c < bkey))) {
                    bt = t;
                    bkey = base + c;
                }
            }
        }
        share_best(best_r, known, bt, bkey);
        // one barrier: publishes the reach, lands the staged quarter and
        // frees this one
        reach_partials(sm.red[nv & 1], needs(live, ANY_HIT, bkey), bt, y, far);
        __pipeline_wait_prior(0);
        __syncthreads();
        R = reach_read(sm.red[nv & 1]);
        j = next_pass(j + 1);
        if (j >= j1) break;
        if (j != staged) {
            // the smaller reach skips the staged tile: stage the one
            // that passes over it (its copy has landed, nobody reads it)
            stage(j, nv & 1);
            __pipeline_wait_prior(0);
            __syncthreads();
        }
    }
    *n_visits += nv;
}

template <bool CULL, bool ANY_HIT>
__global__ void mt_plan(const int* __restrict__ order,
                        const float* __restrict__ entry,
                        const float* __restrict__ scene, int n_tt,
                        const float* __restrict__ rays, int n,
                        float* __restrict__ t_out, int* __restrict__ idx_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ visits, Work w) {
    __shared__ float red[NW * N_RED];
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const Ray y = load_ray(rays, n, r);
    reach_partials(red, y.mint <= y.maxt, __int_as_float(0x7f800000), y,
                   far_side(y, scene));
    __syncthreads();
    const Reach R = reach_read(red);
    // the positions whose entry bound passes the skyline: a prefix
    const int* ord = order + (size_t)rt * n_tt;
    const float* ent = entry + (size_t)rt * n_tt;
    int j_end = R.any ? n_tt : 0;
    if (CULL && R.any) {
        j_end = prefix_length(n_tt, [&](int p) {
            return ent[ord[p]] <= R.t_hi;
        });
    }
    if (visits != nullptr && threadIdx.x == 0) visits[rt] = 0;
    if (j_end == 0) {
        t_out[r] = __int_as_float(0x7f800000);
        idx_out[r] = -1;
        u_out[r] = 0.0f;
        v_out[r] = 0.0f;
        return;
    }
    w.best[r] = PACKED_MISS;
    if (threadIdx.x == 0) {
        push_record(w, rt, j_end, MT_S, TILE_Q, reach_bits(R));
    }
}

template <bool CULL, bool ANY_HIT>
__global__ void mt_sweep_items(
        const float* __restrict__ tris, int T, const int* __restrict__ order,
        const float* __restrict__ entry, const float* __restrict__ bounds,
        const float* __restrict__ scene, int n_tt,
        const float* __restrict__ rays, int n, float* __restrict__ t_out,
        int* __restrict__ idx_out, float* __restrict__ u_out,
        float* __restrict__ v_out, int* __restrict__ visits, Work w) {
    __shared__ MtSmem sm;
    __shared__ ItemSlot slot;
    // an item of a ray tile that no longer searches, or whose first
    // entry bound lies beyond the published skyline (an upper bound of
    // the item's own), is shut
    auto shut = [&](int rt, int j0, int hi) {
        const size_t at0 = (size_t)rt * n_tt;
        return hi < 0 ||
               (CULL && __float_as_int(entry[at0 + order[at0 + j0]]) > hi);
    };
    int4 it;
    while (pull_item(w, MT_S, TILE_Q, slot, shut, &it)) {
        const int rt = it.x;
        const int r = rt * TILE_N + threadIdx.x;
        const int* ord = order + (size_t)rt * n_tt;
        const float* ent = entry + (size_t)rt * n_tt;
        if (!(it.w & ITEM_SHUT)) {
            const Ray y = load_ray(rays, n, r);
            const bool live = y.mint <= y.maxt;
            const float far = far_side(y, scene);
            unsigned long long known = __ldcg(&w.best[r]);
            float bt;
            int bkey, n_visits = 0;
            unpack_best(known, &bt, &bkey);
            reach_partials(sm.red[0], needs(live, ANY_HIT, bkey), bt, y, far);
            __syncthreads();
            Reach R = reach_read(sm.red[0]);
            mt_walk<CULL, ANY_HIT>(sm, tris, T, ord, ent, bounds, it.y, it.z,
                                   it.w, y, live, far, &w.best[r],
                                   known, bt, bkey, R, &n_visits);
            const unsigned long long p = pack_best(bt, bkey);
            if (p < known) atomicMin(&w.best[r], p);
            if (threadIdx.x == 0) {
                atomicMin(&w.row_hi[rt], reach_bits(R));
                if (visits != nullptr && n_visits > 0) {
                    atomicAdd(&visits[rt], n_visits);
                }
            }
        }
        // the last item of a ray tile writes its rays' answers
        if (last_item(w, rt, slot)) {
            float bt, bu = 0.0f, bv = 0.0f;
            int bkey, bi = -1;
            unpack_best(atomicAdd(&w.best[r], 0ull), &bt, &bkey);
            if (bkey >= 0) {
                // the winner's barycentrics, by the walk's own pair test
                const Ray y = load_ray(rays, n, r);
                bi = ord[bkey / TILE_T] * TILE_T + bkey % TILE_T;
                bool hit;
                float t;
                pair_test_rows<false>(
                    [&](int i) { return tris[(size_t)i * T + bi]; }, y.ox,
                    y.oy, y.oz, y.dx, y.dy, y.dz, y.mint, y.maxt, &hit, &t,
                    &bu, &bv);
            }
            t_out[r] = bt;
            idx_out[r] = bi;
            u_out[r] = bu;
            v_out[r] = bv;
        }
    }
}

template <bool CULL, bool AH>
static int launch(const float* tris, int T, const int* order,
                  const float* entry, const float* bounds, const float* scene,
                  int n_tt, const float* rays, int n, float* t_out,
                  int* idx_out, float* u_out, float* v_out, int* visits,
                  Work w, cudaStream_t stream) {
    const int n_rt = n / TILE_N;
    cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    mt_plan<CULL, AH><<<n_rt, TILE_N, 0, stream>>>(
        order, entry, scene, n_tt, rays, n, t_out, idx_out, u_out, v_out,
        visits, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // as many blocks as the card holds at once, but no more than the
    // items there can be
    static int resident = 0;
    if (resident == 0) {
        resident = resident_blocks(mt_sweep_items<CULL, AH>, TILE_N);
    }
    const long long cap = (long long)n_rt * TILE_Q *
                          ((n_tt + MT_S - 1) / MT_S);
    const int grid = resident < cap ? resident : (int)cap;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    mt_sweep_items<CULL, AH><<<grid, TILE_N, 0, stream>>>(
        tris, T, order, entry, bounds, scene, n_tt, rays, n, t_out, idx_out,
        u_out, v_out, visits, w);
    return (int)cudaGetLastError();
}

// best: (N,) uint64; items: (n_rt, 4) int32; counters: 3 int32;
// pending: (2 n_rt,) int32 (the pending counts, then the published
// skylines); none needs initialising.
extern "C" int mt_sweep_launch(const float* tris, int T, const int* order,
                               const float* entry, const float* bounds,
                               const float* scene, int n_tt, const float* rays,
                               int n, float* t_out, int* idx_out, float* u_out,
                               float* v_out, int any_hit, int cull,
                               int* visits, unsigned long long* best,
                               int* items, int* counters, int* pending,
                               cudaStream_t stream) {
    // the packed best holds position x TILE_T + index in 30 bits
    if (n < TILE_N || n_tt < 1 || n_tt > (1 << 21))
        return (int)cudaErrorInvalidValue;
    const Work w{best, reinterpret_cast<int4*>(items), counters, pending,
                 pending + n / TILE_N};
#define ARGS tris, T, order, entry, bounds, scene, n_tt, rays, n, t_out, \
             idx_out, u_out, v_out, visits, w, stream
    if (cull) {
        return any_hit ? launch<true, true>(ARGS) : launch<true, false>(ARGS);
    }
    return any_hit ? launch<false, true>(ARGS) : launch<false, false>(ARGS);
#undef ARGS
}
