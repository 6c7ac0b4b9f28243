// K1 entry_min: per (256-ray tile, triangle tile) minimum slab-entry
// distance over the tile's live rays, clamped to >= 0, +inf when no
// live ray enters the box.
//
// Replaces the TPU kernel nori_tpu/accel/pallas_mt.py `_entry_kernel`
// (called through `_entry_min_pallas`).
//
// Bound on the H100: arithmetic.  The output is n_rt * n_tt floats and
// the inputs are 32 B per ray plus 32 B per box, while the dense work is
// n_rays * n_tt slab tests.  A test is 12 subtractions and products (no
// FMA contraction), 10 min/max and 3 compares, and the card takes
// min/max and compares at half the rate of adds: 53-64 scheduler slots
// per test measured on the dense form, whatever the loads cost (PERF.md).
// So the design tests fewer boxes.
//
// Design.  The boxes come in BVH order, so consecutive boxes are close
// in space and a ray enters few runs of them (2-3 candidates of 404
// tiles, 7-13 of 1,058 slabs).  A block takes one ray tile and one chunk
// of TILE_N boxes (the grid's second axis, so few ray tiles still fill
// the card) and stages both in shared memory as two 16-byte words each;
// each run of G lanes folds its G boxes into their group's box by
// shuffles (common.cuh group_box says why that gate is exact).  Then
// each warp takes its own 32 rays, held in registers, through the
// chunk's groups:
//   - lane = ray: the group's box against each ray, one ballot;
//   - for a group that a ray enters, lane = box: each of the warp's 32 / G
//     runs of G lanes takes the entering rays among its own G lanes in
//     turn (two 16-byte loads, the same address in all of a run) against
//     its lanes' G boxes, every lane keeping its box's minimum, which
//     needs no reduction; the runs' and the warps' minima meet in a
//     shared-memory atomicMin on the non-negative float's bits.
// So a ray costs one test per group plus G per group it enters, whatever
// its neighbours in the warp do (shadow rays scatter), and a ray tile
// whose rays all miss a group spends nothing on its boxes; idle lanes
// (mint > maxt) enter no group.  The minimum of clamped entries is the
// clamped minimum, so the clamp is taken once per fold.  With `idx_mask`
// the kernel stores the packed candidate key (bits & ~idx_mask) | box,
// which the callers' row sort takes as it is.  The TPU version's
// 8-ray-tile grid groups and 128-lane tile padding are not needed here.
#include "common.cuh"

#define FULL_MASK 0xffffffffu
#define INF_BITS 0x7f800000
#ifndef KEY_TURN  // scripts/keys_tune.py builds 1 and 4 too
#define KEY_TURN 2  // entering rays a run of lanes tests per turn
#endif

// G boxes per group, 16 or 32; 0 tests every box for every live ray
// (groups of 32 that every live ray enters), to measure the gate against.
template <int G>
__global__ void __launch_bounds__(TILE_N)
entry_min_kernel(const float4* __restrict__ bounds,
                 const float* __restrict__ rays, int* __restrict__ out,
                 int n_tt, int n, int idx_mask) {
    constexpr int GB = G ? G : 32;  // boxes per group
    constexpr int R = 32 / GB;      // rays a warp tests per turn
    __shared__ float4 s_ray[TILE_N][2];
    __shared__ float4 s_box[TILE_N][2];
    __shared__ float4 s_grp[TILE_N / GB][2];
    __shared__ int s_min[TILE_N];
    const int rt = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int j0 = blockIdx.y * TILE_N;
    const int m = min(TILE_N, n_tt - j0);  // boxes of this chunk

    float4 ra, rb;
    staged_ray(rays, n, rt * TILE_N + tid, &ra, &rb);
    s_ray[tid][0] = ra;
    s_ray[tid][1] = rb;
    const bool live = ra.w <= rb.w;

    float4 ba, bb;
    empty_box(&ba, &bb);
    if (tid < m) {
        ba = bounds[2 * (j0 + tid)];
        bb = bounds[2 * (j0 + tid) + 1];
    }
    s_box[tid][0] = ba;
    s_box[tid][1] = bb;
    if (G) {
        group_box<GB>(&ba, &bb);
        if ((lane & (GB - 1)) == 0) {
            s_grp[tid / GB][0] = ba;
            s_grp[tid / GB][1] = bb;
        }
    }
    s_min[tid] = INF_BITS;
    __syncthreads();

    const float inf = __int_as_float(INF_BITS);
    const int slot = lane / GB;               // this lane's run of GB lanes
    const int ray0 = warp * 32 + slot * GB;   // the first ray of that run
    const int n_g = (m + GB - 1) / GB;
    for (int g = 0; g < n_g; ++g) {
        float tn;
        bool enters = live;
        if (G) enters = enters && slab4(s_grp[g][0], s_grp[g][1], ra, rb, &tn);
        const unsigned all = __ballot_sync(FULL_MASK, enters);
        if (all == 0) continue;
        // the entering rays among this run's own GB lanes
        unsigned mask = (all >> (slot * GB)) & (FULL_MASK >> (32 - GB));
        const int j = g * GB + (lane & (GB - 1));
        const float4 ca = s_box[j][0], cb = s_box[j][1];
        float best = inf;
        // KEY_TURN entering rays per turn, for independent chains; a turn
        // past a run's last ray tests its first lane's ray for nothing
        do {
#pragma unroll
            for (int u = 0; u < KEY_TURN; ++u) {
                const bool has = mask != 0;
                const int k = ray0 + (has ? __ffs(mask) - 1 : 0);
                mask &= mask - 1;
                const bool c = slab4(ca, cb, s_ray[k][0], s_ray[k][1], &tn);
                best = fminf(best, has && c ? tn : inf);
            }
        } while (R == 1 ? mask != 0 : __any_sync(FULL_MASK, mask != 0));
        if (best < inf) atomicMin(&s_min[j], __float_as_int(clamp0(best)));
    }
    __syncthreads();
    if (tid < m) {
        const int bits = s_min[tid];
        out[(size_t)rt * n_tt + j0 + tid] =
            idx_mask ? ((bits & ~idx_mask) | (j0 + tid)) : bits;
    }
}

// idx_mask 0 stores the entry distances themselves.
extern "C" int entry_min_launch(const float* bounds, const float* rays,
                                int* out, int n_tt, int n, int idx_mask,
                                cudaStream_t stream) {
    const int n_rt = n / TILE_N;
    if (n_rt > 0 && n_tt > 0) {
        const dim3 grid(n_rt, (n_tt + TILE_N - 1) / TILE_N);
        entry_min_kernel<KEY_GROUP><<<grid, TILE_N, 0, stream>>>(
            reinterpret_cast<const float4*>(bounds), rays, out, n_tt, n,
            idx_mask);
    }
    return (int)cudaGetLastError();
}
