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
// Bound on the H100: arithmetic, n_lanes * n_tt slab tests (53-64 scheduler
// slots each, see entry_min.cu) with a few integer ops on the rare
// candidate; the output is 8 B per lane.
//
// Design.  One thread per lane, its ray in registers; the boxes staged
// in shared memory in chunks of LANE_CHUNK as the two 16-byte words of
// their rows, read by every thread of a warp at the same address (two
// broadcast loads per test), so any tile count is taken.  A box's
// coarse bit depends on the box alone: it is computed once while
// staging (the one division by gsz) and rides in the row's first pad
// word.  A lane has 3 candidates of 101 boxes, so the fold of a
// candidate stays behind a branch: selects on every test cost more
// than the branch saves (PERF.md).  With G > 0 the boxes are also
// folded, while staging, into the box around each G consecutive ones
// (BVH order keeps them close; common.cuh group_box says why the gate
// is exact), and a warp tests a group's boxes only if one of its lanes
// enters the group's box.  The gate is per warp, not per ray as K1's:
// a lane's keys need its candidates in order, and a warp's lanes walk
// together.  It leaves 36-61 of 101 boxes on the wavefront's rays (G
// 8) and 152-218 of 1,058 slabs on shadow rays (G 16); the wrapper
// picks G by the box count.  256 lanes per block: smaller blocks put
// no more warps on an SM and stage the boxes more often.  The TPU
// version's one-hot group matmul and 8-ray-tile grid groups are not
// needed.
#include "common.cuh"

#define LANE_CHUNK 512  // boxes staged per pass (a multiple of every G)
#ifndef LANE_BLOCK  // scripts/keys_tune.py builds 64 and 128 too
#define LANE_BLOCK TILE_N  // lanes per block
#endif
#define FULL_MASK 0xffffffffu

template <int G>
__global__ void lane_keys_kernel(const float4* __restrict__ bounds, int n_tt,
                                 int n_tt_pad, const float* __restrict__ rays,
                                 int n, int* __restrict__ key1,
                                 int* __restrict__ key2) {
    constexpr int GB = G ? G : 1;
    __shared__ float4 s_box[LANE_CHUNK][2];
    __shared__ float4 s_grp[LANE_CHUNK / GB][2];
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = r < n;  // every thread stages, lanes past n only wait
    float4 ra, rb;
    staged_ray(rays, n, in ? r : 0, &ra, &rb);
    const bool live = in && ra.w <= rb.w;
    const int gsz = (n_tt_pad + 29) / 30;
    int first = -1;
    unsigned fine = 0, coarse = 0;
    // box jj of the staged chunk against this lane's ray
    auto test = [&](int jj, int j) {
        float tn;
        const float4 ba = s_box[jj][0], bb = s_box[jj][1];
        if (live && slab4(ba, bb, ra, rb, &tn)) {
            if (first < 0) {
                first = j;
            } else if (j - first <= 20) {
                fine |= 1u << (20 - (j - first));
            }
            coarse |= __float_as_uint(bb.z);
        }
    };
    for (int j0 = 0; j0 < n_tt; j0 += LANE_CHUNK) {
        const int m = min(LANE_CHUNK, n_tt - j0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e0 = 0; e0 < m; e0 += blockDim.x) {
            const int e = e0 + threadIdx.x;
            float4 ba, bb;
            empty_box(&ba, &bb);
            if (e < m) {
                ba = bounds[2 * (j0 + e)];
                bb = bounds[2 * (j0 + e) + 1];
                bb.z = __int_as_float(1 << max(29 - (j0 + e) / gsz, 0));
                s_box[e][0] = ba;
                s_box[e][1] = bb;
            }
            if (G) {
                group_box<GB>(&ba, &bb);
                if ((threadIdx.x & (GB - 1)) == 0 && e < m) {
                    s_grp[e / GB][0] = ba;
                    s_grp[e / GB][1] = bb;
                }
            }
        }
        __syncthreads();
        if (!__any_sync(FULL_MASK, live)) continue;  // a warp of idle lanes
        if (G) {
            for (int g0 = 0; g0 < m; g0 += GB) {
                float tn;
                const bool enters = live && slab4(s_grp[g0 / GB][0],
                                                  s_grp[g0 / GB][1], ra, rb,
                                                  &tn);
                if (!__any_sync(FULL_MASK, enters)) continue;
#pragma unroll
                for (int c = 0; c < GB; ++c) {
                    if (g0 + c < m) test(g0 + c, j0 + g0 + c);
                }
            }
        } else {
#pragma unroll 4
            for (int jj = 0; jj < m; ++jj) test(jj, j0 + jj);
        }
    }
    if (!in) return;
    const int f1 = first < 0 ? n_tt_pad : first;
    key1[r] = (min(f1, 1023) << 20) | (int)fine;
    key2[r] = (int)coarse;
}

// group: boxes per gate group, LANE_GROUP or 2 * LANE_GROUP, or 0 for the
// walk over every box.
extern "C" int lane_keys_launch(const float* bounds, int n_tt, int n_tt_pad,
                                const float* rays, int n, int* key1,
                                int* key2, int group, cudaStream_t stream) {
    if (group != 0 && group != LANE_GROUP && group != 2 * LANE_GROUP) {
        return (int)cudaErrorInvalidValue;
    }
    const int blocks = (n + LANE_BLOCK - 1) / LANE_BLOCK;
    if (blocks > 0) {
        const float4* b4 = reinterpret_cast<const float4*>(bounds);
        if (group == 0) {
            lane_keys_kernel<0><<<blocks, LANE_BLOCK, 0, stream>>>(
                b4, n_tt, n_tt_pad, rays, n, key1, key2);
        } else if (group == LANE_GROUP) {
            lane_keys_kernel<LANE_GROUP><<<blocks, LANE_BLOCK, 0, stream>>>(
                b4, n_tt, n_tt_pad, rays, n, key1, key2);
        } else {
            lane_keys_kernel<2 * LANE_GROUP>
                <<<blocks, LANE_BLOCK, 0, stream>>>(
                    b4, n_tt, n_tt_pad, rays, n, key1, key2);
        }
    }
    return (int)cudaGetLastError();
}
