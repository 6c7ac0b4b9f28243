// Shared helpers of the sweep kernels (nori_tpu_torch/accel/sweep.py).
//
// Layouts, as in the JAX package: rays (8, N) row-major
// [ox, oy, oz, dx, dy, dz, mint, maxt] with N a multiple of TILE_N;
// tile bounds (n_tt, 8) row-major [bmin xyz | bmax xyz | pad 2].
//
// Built without FMA contraction (--fmad=false) and without fast math,
// so every float expression rounds as its plain PyTorch version does.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define TILE_N 256    // rays per ray tile (one block)
#define FINE_T 128    // triangles per triangle tile (resident sweep)
#define STREAM_T 512  // triangles per slab (streamed sweep)
// The resident sweep's two passes (resident_sweep.cu): a ray tile walks
// at most RESIDENT_V keys in the first pass; the rest of a longer row is
// cut into work items of RESIDENT_S keys for the tail pass.  Chosen from
// the living room's visits per ray tile (PERF.md): p50 2 (closest) and
// 12 (any-hit), p99 ~155, max 271 of 404 tiles.  Most closest tiles end
// within 4 visits; shorter walks shorten the longest chain, and below 4
// and 4 the measured times flatten while the work list grows as 1/S.
#define RESIDENT_V 4
#define RESIDENT_S 4
// The streamed sweep (stream_sweep.cu) and the 2-D sweep (mt_sweep.cu)
// stage and test a slab or tile in quarters of STREAM_U and TILE_U
// triangles.  A ray tile's row is cut into chunks of STREAM_S keys (MT_S
// positions of the visit order), and each chunk is taken once per
// quarter as a work item of the persistent blocks.  No first pass walks
// ahead of the items: on the 541,696-triangle ajax stand-in no cap
// leaves less than 60% of the visits behind it before 16 slabs, and a
// closest row prunes as it goes, so its keys are dealt out in order.
// Times flatten between 1 and 4 keys per chunk (PERF.md).
#define STREAM_U 128
#define TILE_U 128
#define STREAM_S 2
#define MT_S 4
// The streamed sweep tests a landed quarter in sub-blocks of STREAM_G
// triangles, each gated per warp by its box (stream_walk); the scene
// carries those boxes (SceneData.tri_sub_boxes).  Chosen from 16, 32
// and 64 by the card's times on the ajax stand-in's rays and a cbox_scan
// step's (PERF.md).
#ifndef STREAM_G  // scripts/stream_tune.py builds other sizes too
#define STREAM_G 32
#endif
// A gate box is widened on every side by GATE_PAD times the largest
// coordinate magnitude of the box and the ray's origin (gate_box).
#ifndef GATE_PAD
#define GATE_PAD 0x1p-12f
#endif

// The key kernels (entry_min.cu, lane_keys.cu) gate their ray-box tests
// by a box around KEY_GROUP (K1) or LANE_GROUP (K3; twice that on many
// boxes) consecutive boxes: the boxes come in BVH order, so neighbours
// are close in space.  Both were chosen from the tests a gate leaves on
// the renders' rays and from the times on the card (PERF.md).
#ifndef KEY_GROUP  // scripts/keys_tune.py builds 32 and 0 (no gate) too
#define KEY_GROUP 16
#endif
#define LANE_GROUP 8

#define NW (TILE_N / 32)  // warps per block

// 1/c with |c| clamped away from zero, keeping the sign (the JAX
// package's slab-test reciprocal).
__device__ __forceinline__ float safe_inv(float c) {
    float cc = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
    return 1.0f / cc;
}

// Slab test of one ray against one AABB: entry distance tn and
// whether the box is a candidate for the interval [mint, maxt].
// The min/max forms only feed comparisons here, so their handling of
// signed zeros does not matter.
__device__ __forceinline__ bool slab(
        const float* b, float ox, float oy, float oz,
        float ix, float iy, float iz, float mint, float maxt, float* tn_out) {
    float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
    float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
    float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    *tn_out = tn;
    return (tn <= tf) && (tf >= mint) && (tn <= maxt);
}

// The streamed sweep's gate: may a triangle inside box b = [lo xyz | hi
// xyz] pass a pair test at a t in [mint, tu] of the ray (o, 1/d = i),
// o_mag the largest |o| component?  False for an empty box (lo > hi: a
// sub-block of padding triangles only).
//
// Conservative, not exact: a BW or MT test that accepts a hit at t puts
// the ray's point at t within some ulps of M of the triangle, hence of
// b (M the largest coordinate magnitude of the box and the origin; the
// count of ulps grows with a sliver's aspect and a grazing ray's
// 1/angle).  The box is widened by GATE_PAD * M = 2^-12 M, 2,048 to
// 4,096 ulps of M, so the ray's interval in the widened box holds t
// with a margin that also covers the slab test's own rounding.
// safe_inv's clamp of |d| < 1e-20 to 1e-20 can shorten that axis's
// interval only to about the margin times 1e20, past any t of a scene.
__device__ __forceinline__ bool gate_box(const float* b, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float o_mag, float mint,
                                         float tu) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
    const float2 hi = __ldg(reinterpret_cast<const float2*>(b + 4));
    if (!(lo.x <= lo.w)) return false;
    const float m = fmaxf(
        fmaxf(o_mag, fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)), fabsf(lo.z))),
        fmaxf(fmaxf(fabsf(lo.w), fabsf(hi.x)), fabsf(hi.y)));
    const float e = m * GATE_PAD;
    const float w[6] = {lo.x - e, lo.y - e, lo.z - e,
                        lo.w + e, hi.x + e, hi.y + e};
    float tn;
    return slab(w, ox, oy, oz, ix, iy, iz, mint, tu, &tn);
}

// The same test on a box and a ray held as two 16-byte words each, as
// the key kernels stage them: a bounds row as it lies in memory, ba =
// [bmin xyz | bmax x], bb = [bmax yz | pad 2], and a ray as ra = [o xyz |
// mint], rb = [1/d xyz | maxt] (staged_ray).
__device__ __forceinline__ bool slab4(float4 ba, float4 bb, float4 ra,
                                      float4 rb, float* tn_out) {
    const float b[6] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y};
    return slab(b, ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w, tn_out);
}

// Ray r of the (8, n) rays as slab4 takes it, the direction inverted.
__device__ __forceinline__ void staged_ray(const float* rays, int n, int r,
                                           float4* ra, float4* rb) {
    *ra = make_float4(rays[0 * n + r], rays[1 * n + r], rays[2 * n + r],
                      rays[6 * n + r]);
    *rb = make_float4(safe_inv(rays[3 * n + r]), safe_inv(rays[4 * n + r]),
                      safe_inv(rays[5 * n + r]), rays[7 * n + r]);
}

// A box that no min or max of boxes notices: what a lane past the last
// box contributes to its group's box.
__device__ __forceinline__ void empty_box(float4* ba, float4* bb) {
    const float inf = __int_as_float(0x7f800000);
    *ba = make_float4(inf, inf, inf, -inf);
    *bb = make_float4(-inf, -inf, 0.0f, 0.0f);
}

// The box around the boxes (ba, bb) of each aligned run of G lanes (G a
// power of two up to 32), in every lane of the run; bb's pad words are
// zero.  Every lane of the warp must call it.
//
// Such a group box gates its boxes exactly: it contains each of them,
// and float32 subtraction of the same origin, multiplication by the same
// reciprocal, min and max are all monotone, so the group's entry distance
// is <= and its exit distance >= the box's as computed, and a ray for
// which the box is a candidate (tn <= tf, tf >= mint, tn <= maxt) finds
// the group a candidate too.  That holds for finite boxes and rays, where
// no product is a NaN (safe_inv is finite and never zero).
template <int G>
__device__ __forceinline__ void group_box(float4* ba, float4* bb) {
    float lx = ba->x, ly = ba->y, lz = ba->z;
    float hx = ba->w, hy = bb->x, hz = bb->y;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
        lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
        ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
        lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
        hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, o));
        hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, o));
        hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, o));
    }
    *ba = make_float4(lx, ly, lz, hx);
    *bb = make_float4(hy, hz, 0.0f, 0.0f);
}

// max(x, +0): a non-positive x (and -0) becomes +0, as XLA's maximum
// does, so the float's bits order like the float itself.
__device__ __forceinline__ float clamp0(float x) { return x > 0.0f ? x : 0.0f; }

// Block-wide max of one int per thread (blockDim.x == TILE_N); s_buf
// holds TILE_N / 32 ints.  Every thread of the block must call it.
__device__ __forceinline__ int block_max_int(int v, int* s_buf) {
    v = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) s_buf[threadIdx.x >> 5] = v;
    __syncthreads();
    int m = s_buf[0];
#pragma unroll
    for (int w = 1; w < TILE_N / 32; ++w) m = max(m, s_buf[w]);
    __syncthreads();
    return m;
}

// t_hi contribution of one lane: its useful t as non-negative float bits
__device__ __forceinline__ int t_cap_bits(bool live, float bt, float maxt) {
    float tc = live ? fminf(bt, maxt) : 0.0f;
    return __float_as_int(clamp0(tc));
}

// One ray against one triangle whose operand row i is R(i); the
// expressions round exactly as the plain versions in accel/sweep.py
// (left-to-right sums, no FMA), wherever the rows are read from.  u_out
// and v_out, when given, receive the raw barycentrics.
template <bool BW, class Rows>
__device__ __forceinline__ void pair_test_rows(
        Rows R, float ox, float oy, float oz, float dx, float dy, float dz,
        float mint, float maxt, bool* hit, float* t_out,
        float* u_out = nullptr, float* v_out = nullptr) {
    bool ok;
    float t, u, v;
    if constexpr (BW) {
        // rows [n(3) | d_plane | U(3) | u_w | V(3) | v_w]
        float den = R(0) * dx + R(1) * dy + R(2) * dz;
        ok = fabsf(den) > 1e-8f;
        float inv_den = 1.0f / (ok ? den : 1.0f);
        t = -(R(0) * ox + R(1) * oy + R(2) * oz + R(3)) * inv_den;
        float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
        u = R(4) * px + R(5) * py + R(6) * pz + R(7);
        v = R(8) * px + R(9) * py + R(10) * pz + R(11);
    } else {
        // rows [v0(3) | e1(3) | e2(3)]
        float e1x = R(3), e1y = R(4), e1z = R(5);
        float e2x = R(6), e2y = R(7), e2z = R(8);
        float px = dy * e2z - dz * e2y;
        float py = dz * e2x - dx * e2z;
        float pz = dx * e2y - dy * e2x;
        float det = e1x * px + e1y * py + e1z * pz;
        ok = fabsf(det) > 1e-8f;
        float inv_det = 1.0f / (ok ? det : 1.0f);
        float tx = ox - R(0), ty = oy - R(1), tz = oz - R(2);
        u = (tx * px + ty * py + tz * pz) * inv_det;
        float qx = ty * e1z - tz * e1y;
        float qy = tz * e1x - tx * e1z;
        float qz = tx * e1y - ty * e1x;
        v = (dx * qx + dy * qy + dz * qz) * inv_det;
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    }
    *hit = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
           (u + v <= 1.0f) && (t >= mint) && (t <= maxt);
    *t_out = t;
    if (u_out != nullptr) *u_out = u;
    if (v_out != nullptr) *v_out = v;
}

// pair_test_rows against staged triangle c of a tile whose operand rows
// are STRIDE floats apart.
template <bool BW, int STRIDE>
__device__ __forceinline__ void pair_test(
        const float* tri, int c, float ox, float oy, float oz,
        float dx, float dy, float dz, float mint, float maxt,
        bool* hit, float* t_out, float* u_out = nullptr,
        float* v_out = nullptr) {
    pair_test_rows<BW>([&](int i) { return tri[i * STRIDE + c]; }, ox, oy,
                       oz, dx, dy, dz, mint, maxt, hit, t_out, u_out, v_out);
}

// The matmul-form pair test (K2-mxu): one ray's features f = [o, d,
// o x d, 1] against staged triangle c of a tile's (10, 4 x FINE_T)
// weight block, whose columns are [det | u_num | v_num | t_num] blocks
// of FINE_T.  Each numerator is a 10-term sum in feature order, as the
// plain version (sweep._mxu_pair_test) takes it.
__device__ __forceinline__ void mxu_pair_test(
        const float* w, int c, const float* f, float mint, float maxt,
        bool* hit, float* t_out) {
    float s[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const float* col = w + b * FINE_T + c;
        float acc = f[0] * col[0];
#pragma unroll
        for (int k = 1; k < 10; ++k) acc = acc + f[k] * col[k * 4 * FINE_T];
        s[b] = acc;
    }
    const bool ok = fabsf(s[0]) > 1e-8f;
    const float rcp = 1.0f / (ok ? s[0] : 1.0f);
    const float u = s[1] * rcp, v = s[2] * rcp, t = s[3] * rcp;
    *hit = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
           (u + v <= 1.0f) && (t >= mint) && (t <= maxt);
    *t_out = t;
}

// ---------------------------------------------------------------------
// What the two-pass sweeps share (resident_sweep.cu, stream_sweep.cu,
// mt_sweep.cu): the packed per-ray best, the work list, the rays, the
// skyline reduction and the staging copy.
// ---------------------------------------------------------------------

// the packed best of a ray that has no hit: larger than any hit's word
#define PACKED_MISS 0xFF800000FFFFFFFFull

// (t, idx) as one word whose unsigned order is the fold's: the high
// half an order-preserving image of t in which -0 and +0 are equal,
// the low half idx << 1 with t's sign bit below it, so a -0 winner
// keeps its sign.
__device__ __forceinline__ unsigned long long pack_best(float t, int i) {
    if (i < 0) return PACKED_MISS;
    const unsigned b = __float_as_uint(t);
    const unsigned hi = t == 0.0f ? 0x80000000u
                      : (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return ((unsigned long long)hi << 32) | ((unsigned)i << 1) | (b >> 31);
}

__device__ __forceinline__ void unpack_best(unsigned long long p, float* t,
                                            int* i) {
    const unsigned hi = (unsigned)(p >> 32), lo = (unsigned)p;
    if (lo == 0xFFFFFFFFu) {
        *t = __int_as_float(0x7f800000);
        *i = -1;
        return;
    }
    const unsigned b = hi == 0x80000000u ? lo << 31
                     : (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
    *t = __uint_as_float(b);
    *i = (int)(lo >> 1);
}

// Publishes a thread's best (bt, bi) to its ray's packed best in device
// memory if it is better than `known`, the smallest word this thread
// knows to be there, and adopts the word it then finds there if that is
// better still: work items that share a ray tile see each other's hits
// while they run.  Exact: the word only ever holds a real hit.  Done
// after every quarter it is 8% faster on closest rows than at an item's
// start and end only, and costs any-hit rows nothing (PERF.md).
__device__ __forceinline__ void share_best(unsigned long long* best_r,
                                           unsigned long long& known,
                                           float& bt, int& bi) {
    const unsigned long long mine = pack_best(bt, bi);
    if (mine < known) {
        atomicMin(best_r, mine);
        known = mine;
    }
    const unsigned long long there = __ldcg(best_r);
    if (there < mine) {
        unpack_best(there, &bt, &bi);
        known = there;
    }
}

// The scratch of the work items, in the caller's workspace.  The
// resident sweep lists items (ray tile, first key, end key, any-hit) and
// counts [items pushed, items pulled]; the streamed and 2-D sweeps list
// one record per ray tile (below).
struct Work {
    unsigned long long* best;  // (N,) packed best of rays with items
    int4* items;
    int* counters;
    int* pending;              // (n_rt,) items left per ray tile
    int* row_hi;               // (n_rt,) published skylines (K5, K6), or null
};

// ---- the work items of the streamed and 2-D sweeps ----
// The scratch as their plan leaves it: w.items holds one record per ray
// tile with work (ray tile, first key or position, end, chunks),
// w.counters [records, item numbers pulled, most chunks of a record],
// w.pending the items each ray tile still waits for, w.row_hi the
// skyline it has published: t_hi's bits, an upper bound of every later
// one, or -1 once no ray searches.

#define ITEM_SHUT 256  // flag beside the quarter in an item's fourth word

// What the threads of a persistent block pass each other between items.
struct ItemSlot {
    int4 item;
    bool last;
};

// The length of the prefix of [0, n) on which pred holds, for a pred
// that holds on a prefix only.  Every thread of the block must call it.
template <class Pred>
__device__ __forceinline__ int prefix_length(int n, Pred pred) {
    int len = 0;
    for (int p0 = 0; p0 < n; p0 += TILE_N) {
        const int p = p0 + threadIdx.x;
        const int c = __syncthreads_count(p < n && pred(p));
        len += c;
        if (c < TILE_N) break;
    }
    return len;
}

// The plan's record of ray tile rt, whose row has work on [0, end): cut
// into chunks of chunk_len, each `quarters` work items; sky is the
// skyline the ray tile starts from.  One thread calls it.
__device__ __forceinline__ void push_record(const Work& w, int rt, int end,
                                            int chunk_len, int quarters,
                                            int sky) {
    const int chunks = (end + chunk_len - 1) / chunk_len;
    w.items[atomicAdd(&w.counters[0], 1)] = make_int4(rt, 0, end, chunks);
    atomicMax(&w.counters[2], chunks);
    w.pending[rt] = chunks * quarters;
    w.row_hi[rt] = sky;
}

// Pulls the block's next work item into *it: (ray tile, first, end,
// quarter | ITEM_SHUT); false once the item numbers are used up.  The
// numbers run chunk-major over the records, `quarters` each: i = (chunk
// x records + record) x quarters + quarter; a record with fewer chunks
// has no such item and the next number is pulled.  shut(ray tile,
// first, its published skyline) says that the item has nothing left to
// test: it then only takes its pending count.
template <class Shut>
__device__ __forceinline__ bool pull_item(const Work& w, int chunk_len,
                                          int quarters, ItemSlot& slot,
                                          Shut shut, int4* it) {
    for (;;) {
        if (threadIdx.x == 0) {
            const long long per_chunk = (long long)w.counters[0] * quarters;
            const long long i = atomicAdd(&w.counters[1], 1);
            int4 got = make_int4(-1, 0, 0, 0);  // the numbers are used up
            if (i < per_chunk * w.counters[2]) {
                const int at = (int)(i % per_chunk);
                const int4 rec = w.items[at / quarters];
                const int first = rec.y + (int)(i / per_chunk) * chunk_len;
                got = make_int4(-2, 0, 0, 0);  // no such item
                if (first < rec.z) {
                    const bool s =
                        shut(rec.x, first, __ldcg(&w.row_hi[rec.x]));
                    got = make_int4(rec.x, first,
                                    min(first + chunk_len, rec.z),
                                    at % quarters | (s ? ITEM_SHUT : 0));
                }
            }
            slot.item = got;
        }
        __syncthreads();
        *it = slot.item;
        __syncthreads();  // read before the next pull writes it
        if (it->x == -1) return false;
        if (it->x >= 0) return true;
    }
}

// Takes one pending count of ray tile rt once the block's item has
// folded its hits.  True, in every thread, in the block that takes the
// last one: every item's folds are then visible, and it writes the ray
// tile's answers.
__device__ __forceinline__ bool last_item(const Work& w, int rt,
                                          ItemSlot& slot) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) slot.last = atomicSub(&w.pending[rt], 1) == 1;
    __syncthreads();
    const bool last = slot.last;
    if (last) __threadfence();
    return last;
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, mint, maxt;
    float f[10];  // MXU features [o, d, o x d, 1] (the TPU kernel's `feats`)
};

__device__ __forceinline__ Ray load_ray(const float* rays, int n, int r) {
    Ray y;
    y.ox = rays[0 * n + r], y.oy = rays[1 * n + r], y.oz = rays[2 * n + r];
    y.dx = rays[3 * n + r], y.dy = rays[4 * n + r], y.dz = rays[5 * n + r];
    y.mint = rays[6 * n + r], y.maxt = rays[7 * n + r];
    const float f[10] = {y.ox, y.oy, y.oz, y.dx, y.dy, y.dz,
                         y.oy * y.dz - y.oz * y.dy, y.oz * y.dx - y.ox * y.dz,
                         y.ox * y.dy - y.oy * y.dx, 1.0f};
#pragma unroll
    for (int i = 0; i < 10; ++i) y.f[i] = f[i];
    return y;
}

// The skyline reduction's slots in shared memory: two sets used in
// turn, so one barrier per reduction suffices.
struct Skyline {
    int red_max[2][NW];
    unsigned red_or[2][NW];
};

// The warps' partial skyline (max of t_cap bits, OR of `need`) into slot
// set s; the caller's next __syncthreads publishes it.
__device__ __forceinline__ void skyline_partials(Skyline& sm, int s,
                                                 bool need, float bt,
                                                 float maxt) {
    const int v = __reduce_max_sync(0xffffffffu, t_cap_bits(need, bt, maxt));
    const unsigned o = __reduce_or_sync(0xffffffffu, need ? 1u : 0u);
    if ((threadIdx.x & 31) == 0) {
        sm.red_max[s][threadIdx.x >> 5] = v;
        sm.red_or[s][threadIdx.x >> 5] = o;
    }
}

// After the barrier: t_hi and whether the walk goes on (any-hit: some
// ray still needs a hit; closest: t_hi > 0), the same in every thread.
__device__ __forceinline__ void skyline_read(const Skyline& sm, int s,
                                             bool ah, int* t_hi,
                                             bool* alive) {
    int m = sm.red_max[s][0];
    unsigned o = sm.red_or[s][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
        m = max(m, sm.red_max[s][w]);
        o |= sm.red_or[s][w];
    }
    *t_hi = m;
    *alive = ah ? o != 0 : m > 0;
}

// Does this ray still search?  (Closest: every live ray; any-hit: the
// live rays without a hit.)
__device__ __forceinline__ bool needs(bool live, bool ah, int bi) {
    return live && !(ah && bi >= 0);
}

// The skyline of the block's starting state (slot set 0, one barrier).
__device__ __forceinline__ void skyline_start(Skyline& sm, bool live,
                                              bool ah, float bt, int bi,
                                              float maxt, int* t_hi,
                                              bool* alive) {
    skyline_partials(sm, 0, needs(live, ah, bi), bt, maxt);
    __syncthreads();
    skyline_read(sm, 0, ah, t_hi, alive);
}

// This thread's share of the copy of ROWS rows of COLS floats, `stride`
// floats apart at src, into dst (rows COLS apart), in 16-byte chunks;
// one commit group.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(const float* src, size_t stride,
                                           float* dst) {
    constexpr int CHUNKS = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * CHUNKS; e += TILE_N) {
        const int rr = e / CHUNKS, cc = (e - rr * CHUNKS) * 4;
        __pipeline_memcpy_async(dst + rr * COLS + cc, src + rr * stride + cc,
                                16);
    }
    __pipeline_commit();
}

// The blocks of `threads` threads the card holds at once for a kernel.
template <class Kernel>
static int resident_blocks(Kernel kernel, int threads) {
    int dev, sms, per_sm;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) !=
            cudaSuccess) {
        return 0;
    }
    return sms * (per_sm > 1 ? per_sm : 1);
}
