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
// coarsened bounds); bounds (n_tt, 8) those boxes; scene (8,) [centre
// xyz | half diagonal | ...].  Outputs t, idx, u, v, each (N,): the
// closest hit with its raw barycentrics, idx -1 and t +inf on a miss.
// Within a tile ties keep the lowest index, across tiles the earlier
// visit (the TPU kernel's fold).  visits, when not null, receives per
// ray tile the number of tiles it tested.
//
// With cull, a tile is tested only if it overlaps the ray tile's reach
// (the box spanned by the live rays' origins and directions up to t_hi,
// the largest min(bt, maxt, distance to the scene's bounding sphere) of
// a live ray; any-hit counts only rays without a hit) and its entry
// bound does not exceed t_hi (pallas_mt.py:104-151).  The test is
// conservative, so culling skips only tiles that cannot hold a closer
// hit.
//
// Bound on the H100: the pair tests (~56 flops, 512 per ray and tested
// tile) and, per tile, fourteen block-wide reductions of the reach.
// Design: one block per 256-ray tile, one thread per ray; the TPU's
// sequential grid axis and scratch accumulators become a loop inside
// the block over the tile order, the closest hit kept in registers.  A
// passing tile's 9 x 512 operand (18 KB) is staged in shared memory and
// every thread tests its ray against all of it.
#include "common.cuh"

#define TILE_T 512  // triangles per tile of the 2-D sweep

constexpr int N_RED = 14;  // t_hi, any live, 3 x (o_lo, o_hi, d_lo, d_hi)

// Block-wide min or max of N_RED floats per thread (slot 0 and 1 are
// maxima, then per axis min, max, min, max); every thread gets the
// results.  s holds (TILE_N / 32) x N_RED floats.
__device__ __forceinline__ void block_reach(float* v, float* s) {
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
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N_RED; ++i) {
        const bool is_max = i < 2 || ((i - 2) & 1);
        float m = s[i];
        for (int w = 1; w < TILE_N / 32; ++w) {
            m = is_max ? fmaxf(m, s[w * N_RED + i]) : fminf(m, s[w * N_RED + i]);
        }
        v[i] = m;
    }
    __syncthreads();
}

template <bool CULL, bool ANY_HIT>
__global__ void __launch_bounds__(TILE_N) mt_sweep_kernel(
        const float* __restrict__ tris, int T, const int* __restrict__ order,
        const float* __restrict__ entry, const float* __restrict__ bounds,
        const float* __restrict__ scene, int n_tt,
        const float* __restrict__ rays, int n, float* __restrict__ t_out,
        int* __restrict__ idx_out, float* __restrict__ u_out,
        float* __restrict__ v_out, int* __restrict__ visits) {
    __shared__ float s_tri[9][TILE_T];
    __shared__ float s_red[(TILE_N / 32) * N_RED];
    const int rt = blockIdx.x;
    const int r = rt * TILE_N + threadIdx.x;
    const float ox = rays[0 * n + r], oy = rays[1 * n + r], oz = rays[2 * n + r];
    const float dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    const float mint = rays[6 * n + r], maxt = rays[7 * n + r];
    const bool live0 = mint <= maxt;
    float dist_c = 0.0f;
    if (CULL) {
        const float ex = ox - scene[0], ey = oy - scene[1], ez = oz - scene[2];
        dist_c = sqrtf(ex * ex + ey * ey + ez * ez);
    }
    const float half_diag = scene[3];

    float bt = __int_as_float(0x7f800000);  // +inf
    int bi = -1;
    float bu = 0.0f, bv = 0.0f;
    int n_visits = 0;
    const int* ord = order + (size_t)rt * n_tt;
    const float* ent = entry + (size_t)rt * n_tt;

    for (int j = 0; j < n_tt; ++j) {
        const int jj = ord[j];
        bool overlap = true;
        if (CULL) {
            const bool live = live0 && !(ANY_HIT && bi >= 0);
            const float big = 3e37f;
            float v[N_RED];
            const float t_cap = fminf(fminf(bt, maxt), dist_c + half_diag);
            v[0] = live ? t_cap : 0.0f;
            v[1] = live ? 1.0f : 0.0f;
            const float oc[3] = {ox, oy, oz}, dc[3] = {dx, dy, dz};
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                v[2 + 4 * a] = live ? oc[a] : big;
                v[3 + 4 * a] = live ? oc[a] : -big;
                v[4 + 4 * a] = live ? dc[a] : 0.0f;
                v[5 + 4 * a] = live ? dc[a] : 0.0f;
            }
            block_reach(v, s_red);
            const float t_hi = fmaxf(v[0], 0.0f);
            const float* b = bounds + (size_t)jj * 8;
            overlap = true;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const float lo = v[2 + 4 * a] + t_hi * fminf(v[4 + 4 * a], 0.0f);
                const float hi = v[3 + 4 * a] + t_hi * fmaxf(v[5 + 4 * a], 0.0f);
                overlap = overlap && hi >= b[a] && lo <= b[3 + a];
            }
            overlap = overlap && ent[jj] <= t_hi;
            if (ANY_HIT) overlap = overlap && v[1] > 0.0f;
        }
        if (!overlap) continue;  // uniform: every thread reduced alike
        ++n_visits;
        for (int e = threadIdx.x; e < 9 * TILE_T; e += TILE_N) {
            const int rr = e / TILE_T, cc = e - rr * TILE_T;
            s_tri[rr][cc] = tris[(size_t)rr * T + (size_t)jj * TILE_T + cc];
        }
        __syncthreads();
        if (live0) {
            // the tile's closest hit, lowest lane on ties, then folded
            // strictly: an earlier visit keeps a tie
            float tm = __int_as_float(0x7f800000);
            int tl = -1;
            float tu = 0.0f, tv = 0.0f;
            for (int c = 0; c < TILE_T; ++c) {
                bool hit;
                float t, u, v;
                pair_test<false, TILE_T>(&s_tri[0][0], c, ox, oy, oz, dx, dy,
                                         dz, mint, maxt, &hit, &t, &u, &v);
                if (hit && t < tm) {
                    tm = t;
                    tl = c;
                    tu = u;
                    tv = v;
                }
            }
            if (tl >= 0 && tm < bt) {
                bt = tm;
                bi = jj * TILE_T + tl;
                bu = tu;
                bv = tv;
            }
        }
        __syncthreads();  // the tile is read before the next one lands
    }
    t_out[r] = bt;
    idx_out[r] = bi;
    u_out[r] = bu;
    v_out[r] = bv;
    if (visits != nullptr && threadIdx.x == 0) visits[rt] = n_visits;
}

extern "C" int mt_sweep_launch(const float* tris, int T, const int* order,
                               const float* entry, const float* bounds,
                               const float* scene, int n_tt, const float* rays,
                               int n, float* t_out, int* idx_out, float* u_out,
                               float* v_out, int any_hit, int cull,
                               int* visits, cudaStream_t stream) {
    if (n >= TILE_N) {
#define LAUNCH(C, AH)                                                        \
    mt_sweep_kernel<C, AH><<<n / TILE_N, TILE_N, 0, stream>>>(               \
        tris, T, order, entry, bounds, scene, n_tt, rays, n, t_out, idx_out, \
        u_out, v_out, visits)
        if (cull) {
            if (any_hit) LAUNCH(true, true); else LAUNCH(true, false);
        } else {
            if (any_hit) LAUNCH(false, true); else LAUNCH(false, false);
        }
#undef LAUNCH
    }
    return (int)cudaGetLastError();
}
