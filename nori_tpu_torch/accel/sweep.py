"""Ray/triangle sweep kernels and their plain PyTorch versions.

Counterpart of `nori_tpu/accel/pallas_mt.py`, every kernel of it:

  K1 `entry_min`             <- `_entry_kernel`       (pallas_mt.py:896)
  K2 `resident_sweep`        <- `_mt_resident_kernel` (pallas_mt.py:291)
  K2-mxu `resident_sweep_mxu`    the same, `use_mxu=True`
  K3 `lane_keys`             <- `_lane_key_kernel`    (pallas_mt.py:982)
  K4 `resident_sweep_mixed`      the same, `mixed=True`
  K5 `stream_sweep`          <- `_mt_stream_kernel`   (pallas_mt.py:526)
  K5-cull `stream_sweep_culled`  the same, `n_sub > 1`
  K6 `mt_sweep`              <- `_mt_kernel`          (pallas_mt.py:77)

Each wrapper launches its CUDA kernel (nori_tpu_torch/csrc/) for
tensors on a CUDA device and uses its plain version, defined beside it,
only for tensors on the CPU; there is no fallback from a failed kernel.
Each launch runs with the tensors' card as the current device
(`_launch`), so a render on cuda:1 from a process on cuda:0 runs there.
Each counts its kernel launches in a plain integer attribute
(`entry_min.launches`, ...), which a run can reset and read to show
that its main path went through the kernels.  The sweeps take an
optional `visits` tensor, (n_rt,) int32 on the card, into which the
kernel writes how many triangle groups each ray tile tested (the
streamed sweeps: each warp's gated sub-blocks); the plain versions
sweep densely and leave it untouched.  The resident sweeps (K2, K2-mxu, K4)
allocate their scratch per call, or take it as `workspace`
(resident_workspace), after which tail_items reads how much work the
first pass left to the tail pass.  So do the streamed and the 2-D sweeps
(K5, K5-cull, K6: stream_workspace, stream_work).

Layouts are the JAX package's: rays (8, N) [o | d | mint | maxt] with
N a multiple of TILE_N (pack_rays pads), tile bounds (n_tt, 8)
[bmin | bmax | pad], triangle operands (9, T) [v0 | e1 | e2]
(Moller-Trumbore) or (12, T) Baldwin-Weber rows (scene._build_tri_bw),
T a multiple of FINE_T.  Streamed-scale scenes carry 16-row operands
[v0|e1|e2|0*7] or [bw(12)|0*4], T a multiple of STREAM_T, and their
tile bounds cover STREAM_T-triangle slabs.
"""

from __future__ import annotations

import torch

from nori_tpu_torch import cuda_build

TILE_N = 256   # rays per ray tile
FINE_T = 128   # triangles per triangle tile
STREAM_T = 512  # triangles per slab of the streamed sweep
TILE_T = 512   # triangles per tile of the 2-D sweep (K6)
#: triangles the streamed and the 2-D sweep stage and test at a time: a
#: quarter of a slab or tile, one work item of a chunk (csrc/common.cuh
#: STREAM_U, TILE_U)
STREAM_U = 128
TILE_U = 128
#: keys of a row per chunk of the streamed sweep's work items, and
#: positions of a visit order per chunk of the 2-D sweep's
#: (csrc/common.cuh STREAM_S, MT_S)
STREAM_S = 2
MT_S = 4
#: triangles per sub-block of the streamed sweep's per-warp gate, and the
#: gate's relative widening of a box (csrc/common.cuh STREAM_G, GATE_PAD;
#: SceneData.tri_sub_boxes holds a streamed soup's boxes at STREAM_G)
STREAM_G = 32
GATE_PAD = 2.0 ** -12
#: consecutive boxes under one gate box of the key kernels: K1's group,
#: and K3's below LANE_WIDE boxes, twice that from there on
#: (csrc/common.cuh KEY_GROUP, LANE_GROUP; PERF.md has the counts and
#: times they were chosen by)
KEY_GROUP = 16
LANE_GROUP = 8
LANE_WIDE = 256
#: ray-triangle pairs per chunk of the dense plain sweep (bounds its
#: temporaries to 16 MB each)
_PLAIN_PAIRS = 1 << 22

def pack_rays(o, d, mint, maxt):
    """(N,3)x2 + (N,)x2 -> ((8, Npad) tensor, N), N padded to a TILE_N
    multiple with rays that have mint > maxt and never hit
    (pallas_mt.py:1568)."""
    n = o.shape[0]
    npad = (-n) % TILE_N
    packed = torch.cat([o.T, d.T, mint[None, :], maxt[None, :]], dim=0)
    if npad:
        filler = torch.zeros((8, npad), dtype=packed.dtype,
                             device=packed.device)
        filler[6] = 1.0
        filler[7] = -1.0
        packed = torch.cat([packed, filler], dim=1)
    return packed.contiguous(), n


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rays(rays: torch.Tensor):
    _check(rays, "rays", torch.float32, 2, rays.device)
    if rays.shape[0] != 8 or rays.shape[1] % TILE_N:
        raise ValueError(f"rays: expected (8, N) with N % {TILE_N} == 0, "
                         f"got {tuple(rays.shape)}")


def _launch(entry, device, *args) -> int:
    """Call the C entry point `entry` on `device`'s current stream (its
    last argument) with `device` as the current device, and return its
    CUDA error: the entry points call the runtime on the calling
    thread's current device, which need not be the tensors' card."""
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


def _visits_ptr(visits, n_rt: int, device) -> int:
    """Device pointer of an optional (n_rt,) int32 visit count, or 0."""
    if visits is None:
        return 0
    _check(visits, "visits", torch.int32, 1, device)
    if visits.shape[0] != n_rt:
        raise ValueError(f"visits: expected ({n_rt},), got "
                         f"{tuple(visits.shape)}")
    return visits.data_ptr()


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")


def _slab(bmin, bmax, o, inv_d, mint, maxt):
    """Slab test, broadcasting; returns (candidate, entry tn)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tn <= tf) & (tf >= mint) & (tn <= maxt), tn


def _safe_inv(d):
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


# ---------------------------------------------------------------------------
# K1: per (ray tile, triangle tile) minimum entry distance
# ---------------------------------------------------------------------------

def entry_min_plain(tile_bounds, rays):
    """(n_rt, n_tt) minimum over each 256-ray tile's live rays of the
    slab-entry distance to each tile box, clamped to >= 0; +inf where
    no live ray enters."""
    n = rays.shape[1]
    n_rt = n // TILE_N
    o = rays[0:3].T.reshape(n_rt, TILE_N, 1, 3)
    inv_d = _safe_inv(rays[3:6].T).reshape(n_rt, TILE_N, 1, 3)
    mint = rays[6].reshape(n_rt, TILE_N, 1)
    maxt = rays[7].reshape(n_rt, TILE_N, 1)
    cand, tn = _slab(tile_bounds[:, 0:3], tile_bounds[:, 3:6], o, inv_d,
                     mint, maxt)
    cand = cand & (mint <= maxt)
    # where(tn > 0, tn, +0): a -0 entry becomes +0, as XLA's maximum
    # gives, so the float bits order like the floats
    entry = torch.where(cand, torch.where(tn > 0, tn, 0.0), float("inf"))
    return torch.amin(entry, dim=1)


def _pack_entry_keys(entry, idx_bits: int):
    """(n_rt, n_tt) entry distances -> int32 candidate keys: the float's
    bits with the box index in the low idx_bits bits."""
    mask = (1 << idx_bits) - 1
    idx = torch.arange(entry.shape[1], dtype=torch.int32,
                       device=entry.device)
    return (entry.view(torch.int32) & ~mask) | idx[None, :]


def _check_bounds(tile_bounds, device):
    _check(tile_bounds, "tile_bounds", torch.float32, 2, device)
    if tile_bounds.shape[1] != 8:
        raise ValueError(f"tile_bounds: expected (n_tt, 8), got "
                         f"{tuple(tile_bounds.shape)}")
    if tile_bounds.data_ptr() % 16:
        raise ValueError("tile_bounds: rows must be 16-byte aligned")


def entry_min(tile_bounds, rays, idx_bits: int | None = None):
    """K1 wrapper: (n_tt, 8) bounds, (8, N) rays -> (n_rt, n_tt) f32; with
    idx_bits, the int32 candidate keys (bits & ~mask) | box index that
    ray_tile_entry_keys sorts, stored by the kernel itself.

    Kernel: csrc/entry_min.cu, replacing pallas_mt.py `_entry_kernel`.
    Bound on the H100 by the arithmetic of the slab tests.  A block takes a
    ray tile and a chunk of 256 boxes; each warp tests its 32 rays
    against the box around every KEY_GROUP consecutive boxes and, only
    for a group that a ray enters, that ray against the group's boxes,
    one box per lane.  The gate is exact (csrc/common.cuh group_box).
    """
    _check_rays(rays)
    _check_bounds(tile_bounds, rays.device)
    if idx_bits is not None and not 1 <= idx_bits <= 23:
        raise ValueError(f"idx_bits: expected 1..23, got {idx_bits}")
    if rays.device.type == "cpu":
        entry = entry_min_plain(tile_bounds, rays)
        return entry if idx_bits is None else _pack_entry_keys(entry,
                                                               idx_bits)
    n_tt, n = tile_bounds.shape[0], rays.shape[1]
    out = torch.empty(
        (n // TILE_N, n_tt), device=rays.device,
        dtype=torch.float32 if idx_bits is None else torch.int32)
    lib = cuda_build.load()
    err = _launch(
        lib.entry_min_launch, rays.device, tile_bounds.data_ptr(),
        rays.data_ptr(), out.data_ptr(), n_tt, n,
        0 if idx_bits is None else (1 << idx_bits) - 1)
    entry_min.launches += 1
    _raise_on(err, "entry_min")
    return out


entry_min.launches = 0


def ray_tile_entry_keys(tile_bounds, rays):
    """Packed candidate keys for the resident sweep
    (pallas_mt.py:1179, uncapped).

    Per (ray tile, triangle tile): the minimum entry distance's float
    bits with the tile index in the low idx_bits bits, rows sorted
    ascending as int32, so one word carries the visit order and a
    rounded-down entry bound.  Non-candidates pack to inf/NaN bit
    patterns that sort last.  Returns ((n_rt, n_tt) int32, idx_bits).
    """
    idx_bits = max(1, (tile_bounds.shape[0] - 1).bit_length())
    keys = torch.sort(entry_min(tile_bounds, rays, idx_bits=idx_bits),
                      dim=1).values
    return keys.contiguous(), idx_bits


# ---------------------------------------------------------------------------
# K2: resident sweep (closest or any hit)
# ---------------------------------------------------------------------------

def _pair_test(tris, o, d, mint, maxt):
    """Rays (n, 1) columns against a (rows, C) operand block; returns
    (hit, t) of shape (n, C).  The expressions round as the kernel's
    (left-to-right sums, no fused multiply-add)."""
    return _pair_test_uv(tris, o, d, mint, maxt)[:2]


def _pair_test_uv(tris, o, d, mint, maxt):
    """_pair_test, also returning the raw barycentrics: (hit, t, u, v)."""
    ox, oy, oz = o
    dx, dy, dz = d
    if tris.shape[0] == 12:
        nx, ny, nz, dn = tris[0], tris[1], tris[2], tris[3]
        den = nx * dx + ny * dy + nz * dz
        ok = torch.abs(den) > 1e-8
        inv_den = 1.0 / torch.where(ok, den, 1.0)
        t = -(nx * ox + ny * oy + nz * oz + dn) * inv_den
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        u = tris[4] * px + tris[5] * py + tris[6] * pz + tris[7]
        v = tris[8] * px + tris[9] * py + tris[10] * pz + tris[11]
    else:
        e1x, e1y, e1z = tris[3], tris[4], tris[5]
        e2x, e2y, e2z = tris[6], tris[7], tris[8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) > 1e-8
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        tx, ty, tz = ox - tris[0], oy - tris[1], oz - tris[2]
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint) & (t <= maxt))
    return hit, t, u, v


def _dense_closest(T: int, test, rays, n_extra: int = 0):
    """Dense closest-hit sweep of every live ray against T triangles,
    chunked over triangles.  test(c0, c1, o, d, mint, maxt) gives (hit,
    t, *extra) for triangles [c0, c1) as (m, c1 - c0) arrays.  Returns
    (t (N,) f32, idx (N,) int32, *extra at the winner): idx -1 and t
    +inf on a miss, the lowest index winning ties in t."""
    n = rays.shape[1]
    dev = rays.device
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    idx_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    extra_out = [torch.zeros((n,), dtype=torch.float32, device=dev)
                 for _ in range(n_extra)]
    sel = torch.nonzero(rays[6] <= rays[7]).squeeze(1)
    m = sel.shape[0]
    if m == 0:
        return (t_out, idx_out, *extra_out)
    r = rays[:, sel]
    o = (r[0][:, None], r[1][:, None], r[2][:, None])
    d = (r[3][:, None], r[4][:, None], r[5][:, None])
    mint, maxt = r[6][:, None], r[7][:, None]
    chunk = max(FINE_T, _PLAIN_PAIRS // m // FINE_T * FINE_T)
    best_t = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((m,), -1, dtype=torch.int64, device=dev)
    best_x = [torch.zeros((m,), dtype=torch.float32, device=dev)
              for _ in range(n_extra)]
    for c0 in range(0, T, chunk):
        hit, t, *extra = test(c0, min(c0 + chunk, T), o, d, mint, maxt)
        tmin, j = torch.min(torch.where(hit, t, float("inf")), dim=1)
        better = tmin < best_t   # strict: earlier chunks win ties
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, j + c0, best_i)
        best_x = [torch.where(better, x.gather(1, j[:, None])[:, 0], b)
                  for x, b in zip(extra, best_x)]
    t_out[sel] = best_t
    idx_out[sel] = best_i.to(torch.int32)
    for x, b in zip(extra_out, best_x):
        x[sel] = b
    return (t_out, idx_out, *extra_out)


def resident_sweep_plain(tris_op, rays, any_hit: bool = False):
    """Dense sweep of every live ray against every triangle, chunked
    over triangles.  Returns (t (N,) f32, idx (N,) int32), idx -1 on a
    miss, the lowest index winning ties in t.  The kernel's candidate
    walk and skyline exit only skip tiles that cannot hold a closer hit,
    so the dense sweep gives the same closest hit.  For any-hit only
    idx >= 0 is meaningful (here it is the closest hit)."""
    del any_hit

    def test(c0, c1, o, d, mint, maxt):
        return _pair_test(tris_op[:, c0:c1], o, d, mint, maxt)

    return _dense_closest(tris_op.shape[1], test, rays)


def _check_keys(keys, idx_bits: int, n_rt: int, n_tt: int, unit: str):
    if tuple(keys.shape) != (n_rt, n_tt):
        raise ValueError(f"keys: expected ({n_rt}, {n_tt}), got "
                         f"{tuple(keys.shape)}")
    # tile indices sit below the entry bits' low mantissa (< 23 bits)
    if not 1 <= idx_bits <= 22 or (1 << idx_bits) < n_tt:
        raise ValueError(f"idx_bits {idx_bits} cannot index {n_tt} {unit}")


_OP_MT, _OP_BW, _OP_MXU = 0, 1, 2
#: keys a ray tile walks in the resident sweep's first pass, and keys per
#: work item of its tail pass (csrc/common.cuh RESIDENT_V, RESIDENT_S)
RESIDENT_V = 4
RESIDENT_S = 4


def _workspace_layout(n: int, n_keys: int):
    """(work list capacity, int32 words) of the resident sweep's scratch
    for n rays and key rows of n_keys."""
    cap = n // TILE_N * -(-n_keys // RESIDENT_S)
    return cap, 2 * n + 4 * cap + 2 + n // TILE_N


def resident_workspace(n: int, n_keys: int, device):
    """Scratch of the two-pass resident sweep, one int32 tensor: the
    per-ray packed best (n int64), the work list, sized for the worst
    case of n_rt * ceil(n_keys / RESIDENT_S) items of 4 int32, two
    counters (items pushed, items pulled) and one pending count per ray
    tile.  The kernel initialises what it reads."""
    return torch.empty((_workspace_layout(n, n_keys)[1],), dtype=torch.int32,
                       device=device)


def tail_items(workspace, n: int, n_keys: int) -> int:
    """The work items that the last resident sweep run on `workspace`
    (for n rays, key rows of n_keys) pushed to its tail pass; reads the
    device."""
    return int(workspace[2 * n + 4 * _workspace_layout(n, n_keys)[0]])


def _resident_launch(op: int, tris_op, T: int, keys, idx_bits: int, rays,
                     any_hit: bool, tile_ah, visits, workspace):
    if tris_op.data_ptr() % 16:
        raise ValueError("tris_op: the tile copies need 16-byte alignment")
    n, n_keys = rays.shape[1], keys.shape[1]
    cap, words = _workspace_layout(n, n_keys)
    if workspace is None:
        workspace = resident_workspace(n, n_keys, rays.device)
    _check(workspace, "workspace", torch.int32, 1, rays.device)
    if workspace.shape[0] < words:
        raise ValueError(f"workspace: {workspace.shape[0]} int32, expected "
                         f"at least {words}")
    best = workspace.data_ptr()
    items = best + 8 * n          # n is a multiple of TILE_N: 16-aligned
    counters = items + 16 * cap
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = _launch(
        lib.resident_sweep_launch, rays.device, tris_op.data_ptr(), op, T,
        keys.data_ptr(), n_keys, idx_bits, rays.data_ptr(), n, t.data_ptr(),
        idx.data_ptr(), int(any_hit),
        0 if tile_ah is None else tile_ah.data_ptr(),
        _visits_ptr(visits, n // TILE_N, rays.device), best, items, counters,
        counters + 8)
    # a workspace allocated here may be freed on return: the caching
    # allocator hands it out again only to work queued after the sweep
    # on the same stream
    return t, idx, err


def resident_sweep(tris_op, keys, idx_bits: int, rays,
                   any_hit: bool = False, visits=None, workspace=None):
    """K2 wrapper: (t (N,) f32, idx (N,) int32) for (8, N) rays against
    the (9, T) or (12, T) operand, walking `keys` from
    ray_tile_entry_keys.

    Kernel: csrc/resident_sweep.cu, replacing pallas_mt.py
    `_mt_resident_kernel`.  Bound on the H100 by the pair-test
    arithmetic once the walks spread over the card: a first pass of
    one block per ray tile walks at most RESIDENT_V keys, staging each
    visited 128-triangle tile in shared memory, and stops at the
    skyline; a tail pass of persistent blocks finishes the longer rows
    in items of RESIDENT_S keys, folding into a packed per-ray best.
    Both launches are queued without a host read between them.  The
    plain version (CPU tensors) sweeps densely and does not read the
    keys.
    """
    _check_rays(rays)
    _check(tris_op, "tris_op", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    rows, T = tris_op.shape
    n = rays.shape[1]
    if rows not in (9, 12) or T % FINE_T:
        raise ValueError(f"tris_op: expected (9|12, T) with T % {FINE_T} "
                         f"== 0, got {tuple(tris_op.shape)}")
    _check_keys(keys, idx_bits, n // TILE_N, T // FINE_T, "tiles")
    if rays.device.type == "cpu":
        return resident_sweep_plain(tris_op, rays, any_hit)
    t, idx, err = _resident_launch(_OP_BW if rows == 12 else _OP_MT, tris_op,
                                   T, keys, idx_bits, rays, any_hit, None,
                                   visits, workspace)
    resident_sweep.launches += 1
    _raise_on(err, "resident_sweep")
    return t, idx


resident_sweep.launches = 0


# ---------------------------------------------------------------------------
# K4: the mixed resident sweep (closest and any-hit ray tiles, one launch)
# ---------------------------------------------------------------------------

def resident_sweep_mixed(tris_op, keys, idx_bits: int, rays, tile_ah,
                         visits=None, workspace=None):
    """K4 wrapper: K2 over (8, N) rays whose 256-ray tiles are each
    flagged closest (0) or any-hit (nonzero) by tile_ah, (N / 256,)
    int32, in one launch.  Returns (t, idx) as resident_sweep; for
    any-hit tiles only idx >= 0 is meaningful.

    Kernel: csrc/resident_sweep.cu with a non-null tile_ah, replacing
    pallas_mt.py `_mt_resident_kernel` with `mixed=True`
    (`mt_sweep_resident_mixed`).  Each block reads its flag once and
    takes the closest or the any-hit exit rule as a block-uniform
    branch; a tail item carries the flag of its ray tile, so both kinds
    share the work list.  The plain version is resident_sweep_plain
    over all rays: it is dense, so the flags change nothing for it.
    """
    _check_rays(rays)
    _check(tris_op, "tris_op", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    _check(tile_ah, "tile_ah", torch.int32, 1, rays.device)
    rows, T = tris_op.shape
    n = rays.shape[1]
    if rows not in (9, 12) or T % FINE_T:
        raise ValueError(f"tris_op: expected (9|12, T) with T % {FINE_T} "
                         f"== 0, got {tuple(tris_op.shape)}")
    _check_keys(keys, idx_bits, n // TILE_N, T // FINE_T, "tiles")
    if tile_ah.shape[0] != n // TILE_N:
        raise ValueError(f"tile_ah: expected ({n // TILE_N},), got "
                         f"{tuple(tile_ah.shape)}")
    if rays.device.type == "cpu":
        return resident_sweep_plain(tris_op, rays)
    t, idx, err = _resident_launch(_OP_BW if rows == 12 else _OP_MT, tris_op,
                                   T, keys, idx_bits, rays, False, tile_ah,
                                   visits, workspace)
    resident_sweep_mixed.launches += 1
    _raise_on(err, "resident_sweep_mixed")
    return t, idx


resident_sweep_mixed.launches = 0


# ---------------------------------------------------------------------------
# K2-mxu: the resident sweep on the matmul-form operand
# ---------------------------------------------------------------------------

def _mxu_weights(tri_mxu):
    """(16, 4T) operand (scene._build_tri_mxu) -> (4, 10, T): the
    [det | u_num | v_num | t_num] weights of each live feature row,
    column = triangle index."""
    T = tri_mxu.shape[1] // 4
    return tri_mxu[:10].reshape(10, T // FINE_T, 4, FINE_T).permute(
        2, 0, 1, 3).reshape(4, 10, T)


def _mxu_pair_test(w4, o, d, mint, maxt):
    """Rays (n, 1) columns against (4, 10, C) weights: features [o, d,
    o x d, 1], each numerator a 10-term sum in feature order, then the
    epilogue of pallas_mt.py:414-422; returns (hit, t), (n, C).  Rounds
    as the kernel's mxu_pair_test (no fused multiply-add)."""
    ox, oy, oz = o
    dx, dy, dz = d
    f = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
         ox * dy - oy * dx, torch.ones_like(ox))
    s = []
    for b in range(4):
        acc = f[0] * w4[b, 0]
        for k in range(1, 10):
            acc = acc + f[k] * w4[b, k]
        s.append(acc)
    det, un, vn, tn = s
    ok = torch.abs(det) > 1e-8
    r = 1.0 / torch.where(ok, det, 1.0)
    u, v, t = un * r, vn * r, tn * r
    hit = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint) & (t <= maxt))
    return hit, t


def resident_sweep_mxu_plain(tri_mxu, rays, any_hit: bool = False):
    """Dense sweep on the (16, 4T) matmul-form operand: the same sums
    as the kernel's, in the same order, elementwise (not a matmul, whose
    summation order is the library's)."""
    del any_hit
    w4 = _mxu_weights(tri_mxu)

    def test(c0, c1, o, d, mint, maxt):
        return _mxu_pair_test(w4[:, :, c0:c1], o, d, mint, maxt)

    return _dense_closest(w4.shape[2], test, rays)


def resident_sweep_mxu(tri_mxu, keys, idx_bits: int, rays,
                       any_hit: bool = False, visits=None, workspace=None):
    """K2-mxu wrapper: resident_sweep on the (16, 4T) matmul-form
    operand `SceneData.tri_mxu` (10 live feature rows).

    Kernel: csrc/resident_sweep.cu (op MXU), replacing pallas_mt.py
    `_mt_resident_kernel` with `use_mxu=True`, in K2's two passes.  Each
    visit stages the tile's 10 x 512 weights (20 KB, double-buffered:
    40 KB a block) in shared memory; each thread forms
    its ray's 10 features and takes det and the three numerators as
    10-term fp32 sums (~90 flops per pair, on the FP32 units: TF32
    tensor cores would lose the hit test's precision).
    """
    _check_rays(rays)
    _check(tri_mxu, "tri_mxu", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    rows, cols = tri_mxu.shape
    n = rays.shape[1]
    if rows != 16 or cols % (4 * FINE_T) or cols == 0:
        raise ValueError(f"tri_mxu: expected (16, 4T) with T % {FINE_T} "
                         f"== 0, got {tuple(tri_mxu.shape)}")
    T = cols // 4
    _check_keys(keys, idx_bits, n // TILE_N, T // FINE_T, "tiles")
    if rays.device.type == "cpu":
        return resident_sweep_mxu_plain(tri_mxu, rays, any_hit)
    t, idx, err = _resident_launch(_OP_MXU, tri_mxu, T, keys, idx_bits, rays,
                                   any_hit, None, visits, workspace)
    resident_sweep_mxu.launches += 1
    _raise_on(err, "resident_sweep_mxu")
    return t, idx


resident_sweep_mxu.launches = 0


# ---------------------------------------------------------------------------
# K3: per-lane coherence sort keys
# ---------------------------------------------------------------------------

def lane_keys_plain(tile_bounds, rays):
    """(key1, key2), each (N,) int32 (see csrc/lane_keys.cu):
    key1 = (min(first candidate, 1023) << 20) | candidate mask of the
    next 20 tiles, key2 = 30-bit coarse OR-mask over groups of
    ceil(n_tt_pad / 30) tiles, n_tt_pad the 128-padded tile count."""
    n_tt = tile_bounds.shape[0]
    n_tt_pad = -(-n_tt // 128) * 128
    dev = rays.device
    o = rays[0:3].T[:, None, :]
    inv_d = _safe_inv(rays[3:6].T)[:, None, :]
    mint, maxt = rays[6][:, None], rays[7][:, None]
    cand, _ = _slab(tile_bounds[:, 0:3], tile_bounds[:, 3:6], o, inv_d,
                    mint, maxt)
    cand = cand & (mint <= maxt)                          # (N, n_tt)
    idx = torch.arange(n_tt, dtype=torch.int64, device=dev)
    first = torch.amin(torch.where(cand, idx, n_tt_pad), dim=1)
    off = idx[None, :] - first[:, None]
    in_win = cand & (off >= 1) & (off <= 20)
    bit = torch.bitwise_left_shift(torch.ones_like(off),
                                   20 - off.clamp(1, 20))
    fine = torch.sum(torch.where(in_win, bit, 0), dim=1)
    # coarse groups: at most 30, so the shifts are distinct and the sum
    # is an OR
    gsz = -(-n_tt_pad // 30)
    n_grp = -(-n_tt // gsz)
    pad = torch.zeros((cand.shape[0], n_grp * gsz - n_tt), dtype=torch.bool,
                      device=dev)
    grp = torch.any(torch.cat([cand, pad], dim=1).reshape(-1, n_grp, gsz),
                    dim=2)
    gi = torch.arange(n_grp, dtype=torch.int64, device=dev)
    coarse = torch.sum(torch.where(
        grp, torch.bitwise_left_shift(torch.ones_like(gi),
                                      torch.clamp_min(29 - gi, 0)), 0),
        dim=1)
    key1 = (torch.clamp_max(first, 1023) << 20) | fine
    return key1.to(torch.int32), coarse.to(torch.int32)


def lane_group(n_tt: int) -> int:
    """Boxes per gate group of K3 on n_tt boxes: LANE_GROUP, twice that
    from LANE_WIDE boxes on, none where there are not two groups."""
    if n_tt < 2 * LANE_GROUP:
        return 0
    return LANE_GROUP if n_tt < LANE_WIDE else 2 * LANE_GROUP


def lane_keys(tile_bounds, rays):
    """K3 wrapper: (n_tt, 8) bounds, (8, N) rays -> (key1, key2), each
    (N,) int32.

    Kernel: csrc/lane_keys.cu, replacing pallas_mt.py
    `_lane_key_kernel`.  Bound on the H100 by the arithmetic of the
    slab tests; one thread per lane walks the tile boxes, staged once per
    block in shared memory with their coarse bits, and builds the masks
    as integers.  A warp skips lane_group(n_tt) consecutive boxes when
    none of its lanes enters the box around them (exact: csrc/common.cuh
    group_box).
    """
    _check_rays(rays)
    _check_bounds(tile_bounds, rays.device)
    n_tt, n = tile_bounds.shape[0], rays.shape[1]
    if rays.device.type == "cpu":
        return lane_keys_plain(tile_bounds, rays)
    k1 = torch.empty((n,), dtype=torch.int32, device=rays.device)
    k2 = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = _launch(
        lib.lane_keys_launch, rays.device, tile_bounds.data_ptr(), n_tt,
        -(-n_tt // 128) * 128, rays.data_ptr(), n, k1.data_ptr(),
        k2.data_ptr(), lane_group(n_tt))
    lane_keys.launches += 1
    _raise_on(err, "lane_keys")
    return k1, k2


lane_keys.launches = 0


# ---------------------------------------------------------------------------
# K5: streamed sweep (closest or any hit) over STREAM_T-triangle slabs
# ---------------------------------------------------------------------------

def stream_sweep_plain(tris_op, rays, any_hit: bool = False,
                       use_bw: bool = True):
    """Dense sweep of the 16-row streamed operand: the resident plain
    sweep on the rows the test reads ([:12] Baldwin-Weber, [:9]
    Moller-Trumbore); the zero padding rows are never read."""
    return resident_sweep_plain(tris_op[:12] if use_bw else tris_op[:9],
                                rays, any_hit)


def _check_stream(tris_op, keys, idx_bits: int, rays):
    _check_rays(rays)
    _check(tris_op, "tris_op", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    rows, T = tris_op.shape
    if rows != 16 or T % STREAM_T or T == 0:
        raise ValueError(f"tris_op: expected (16, T) with T % {STREAM_T} "
                         f"== 0, got {tuple(tris_op.shape)}")
    _check_keys(keys, idx_bits, rays.shape[1] // TILE_N, T // STREAM_T,
                "slabs")


def _stream_layout(n: int):
    """int32 words of the streamed and 2-D sweeps' scratch for n rays,
    and the word offsets of its records and counters."""
    n_rt = n // TILE_N
    return 2 * n + 4 * n_rt + 4 + 2 * n_rt, 2 * n, 2 * n + 4 * n_rt


def stream_workspace(n: int, device):
    """Scratch of the streamed sweep (K5, K5-cull) and the 2-D sweep
    (K6) for n rays, one int32 tensor: the per-ray packed best (n
    int64), one record of 4 int32 per ray tile (ray tile, first key or
    position, end, chunks), the counters (records, item numbers pulled,
    most chunks of a record; one word of padding), and per ray tile a
    pending count and a published skyline.  The kernel initialises what
    it reads."""
    return torch.empty((_stream_layout(n)[0],), dtype=torch.int32,
                       device=device)


def stream_work(workspace, n: int):
    """What the last streamed or 2-D sweep run on `workspace` (for n
    rays) planned: the ray tiles with work, the most chunks one of them
    has, and the work items (one per chunk and quarter; both kernels cut
    a slab or tile in STREAM_T / STREAM_U = TILE_T / TILE_U quarters);
    reads the device."""
    _, rec, cnt = _stream_layout(n)
    records = int(workspace[cnt])
    chunks = workspace[rec:rec + 4 * records].reshape(records, 4)[:, 3]
    return dict(records=records, max_chunks=int(workspace[cnt + 2]),
                items=int(chunks.sum()) * (STREAM_T // STREAM_U))


def _stream_ptrs(workspace, n: int, device):
    """(workspace kept alive, pointers of best, records, counters,
    pending) for a launch on n rays; allocates the scratch if none is
    given."""
    words, rec, cnt = _stream_layout(n)
    if workspace is None:
        workspace = stream_workspace(n, device)
    _check(workspace, "workspace", torch.int32, 1, device)
    if workspace.shape[0] < words:
        raise ValueError(f"workspace: {workspace.shape[0]} int32, expected "
                         f"at least {words}")
    base = workspace.data_ptr()
    # the packed bests take 64-bit atomics and the records 16-byte loads;
    # n is a multiple of TILE_N, so the records are aligned if the base is
    if base % 16:
        raise ValueError("workspace: expected a 16-byte aligned address, as "
                         "stream_workspace gives")
    return workspace, (base, base + 4 * rec, base + 4 * cnt,
                       base + 4 * (cnt + 4))


def _check_sub_boxes(sub_boxes, T: int, sub_t: int, device):
    _check(sub_boxes, "sub_boxes", torch.float32, 2, device)
    if tuple(sub_boxes.shape) != (T // sub_t, 8):
        raise ValueError(f"sub_boxes: expected ({T // sub_t}, 8) boxes of "
                         f"{sub_t} triangles, got {tuple(sub_boxes.shape)}")
    if sub_boxes.data_ptr() % 16:
        raise ValueError("sub_boxes: the gate's box loads need 16-byte "
                         "alignment")


def _tally_ptr(tally, device) -> int:
    """Device pointer of an optional (2,) int64 gate tally, or 0."""
    if tally is None:
        return 0
    _check(tally, "tally", torch.int64, 1, device)
    if tally.shape[0] != 2:
        raise ValueError(f"tally: expected (2,), got {tuple(tally.shape)}")
    return tally.data_ptr()


def _stream_launch(tris_op, keys, idx_bits: int, rays, any_hit: bool,
                   use_bw: bool, sub_t: int, sub_boxes, visits, tally,
                   workspace):
    if tris_op.data_ptr() % 16:
        raise ValueError("tris_op: the slab copies need 16-byte alignment")
    _check_sub_boxes(sub_boxes, tris_op.shape[1], sub_t, rays.device)
    n = rays.shape[1]
    workspace, ptrs = _stream_ptrs(workspace, n, rays.device)
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = _launch(
        lib.stream_sweep_launch, rays.device, tris_op.data_ptr(), int(use_bw),
        tris_op.shape[1], keys.data_ptr(), keys.shape[1], idx_bits,
        rays.data_ptr(), n, t.data_ptr(), idx.data_ptr(), int(any_hit), sub_t,
        sub_boxes.data_ptr(), _visits_ptr(visits, n // TILE_N, rays.device),
        _tally_ptr(tally, rays.device), *ptrs)
    # a workspace allocated here may be freed on return: the caching
    # allocator hands it out again only to work queued after the sweep
    # on the same stream
    return t, idx, err


def stream_sweep(tris_op, keys, idx_bits: int, rays, any_hit: bool = False,
                 use_bw: bool = True, visits=None, workspace=None,
                 sub_boxes=None, tally=None):
    """K5 wrapper: (t (N,) f32, idx (N,) int32) for (8, N) rays against
    the (16, T) streamed operand, walking `keys` from
    ray_tile_entry_keys on the (T / STREAM_T, 8) slab bounds.  use_bw
    says which rows the operand holds (with 16 rows its shape cannot).
    On a card `sub_boxes` is required: the soup's (T / STREAM_G, 8)
    sub-block boxes, SceneData.tri_sub_boxes (stream_sub_boxes).

    Kernel: csrc/stream_sweep.cu, replacing pallas_mt.py
    `_mt_stream_kernel`.  Bound on the H100 by the pair tests'
    arithmetic: the operand stays in L2 and a staged quarter slab is
    6 KB.  Two launches without a host read between them: a plan cuts
    each ray tile's candidate keys into chunks of STREAM_S keys, and
    persistent blocks pull work items, one per chunk and quarter of the
    slabs (STREAM_U triangles), chunk by chunk over all ray tiles, so a
    row's keys stay nearly in order (a closest walk prunes as it goes)
    while every row is worked on at once.  An item starts from its
    rays' packed best, stages its quarters through a cp.async double
    buffer, tests each landed quarter in sub-blocks of STREAM_G
    triangles, each only in the warps one of whose rays may hit it
    within its useful t (its widened box: a gate that skips no answer),
    and folds its hits back with a 64-bit atomic minimum, which is exact
    in any order.  `visits` counts the sub-blocks of STREAM_G that each
    ray tile's warps tested, once a warp; `tally`, a (2,) int64 on the
    card, gets the sub-blocks the warps tested and those their gates
    skipped added to it.  The plain version (CPU tensors) sweeps densely
    and reads neither the keys nor the boxes.
    """
    _check_stream(tris_op, keys, idx_bits, rays)
    if rays.device.type == "cpu":
        return stream_sweep_plain(tris_op, rays, any_hit, use_bw)
    if sub_boxes is None:
        raise ValueError("sub_boxes: the streamed sweep's gate needs the "
                         "soup's sub-block boxes (SceneData.tri_sub_boxes)")
    t, idx, err = _stream_launch(tris_op, keys, idx_bits, rays, any_hit,
                                 use_bw, STREAM_G, sub_boxes, visits, tally,
                                 workspace)
    stream_sweep.launches += 1
    _raise_on(err, "stream_sweep")
    return t, idx


stream_sweep.launches = 0


# ---------------------------------------------------------------------------
# K5-cull: the streamed sweep with sub-slab culling
# ---------------------------------------------------------------------------

def cull_sub_blocks(cull_t: int) -> int:
    """Sub-blocks per slab for a culling granularity (pallas_mt.py:766-
    768): STREAM_T // cull_t for a divisor smaller than STREAM_T, else
    1 (no culling)."""
    if cull_t and STREAM_T % cull_t == 0 and STREAM_T > cull_t:
        return STREAM_T // cull_t
    return 1


def sub_block_boxes(tris_op, cull_t: int):
    """(T / cull_t, 8) boxes [lo xyz | hi xyz | 0 0] of each cull_t
    triangles of the Moller-Trumbore rows [v0 | e1 | e2], computed per
    sweep as pallas_mt.py:770-780 does."""
    v0 = tris_op[0:3]
    p1 = v0 + tris_op[3:6]
    p2 = v0 + tris_op[6:9]
    nq = tris_op.shape[1] // cull_t
    lo = torch.minimum(v0, torch.minimum(p1, p2)).reshape(3, nq, cull_t)
    hi = torch.maximum(v0, torch.maximum(p1, p2)).reshape(3, nq, cull_t)
    return torch.cat([torch.amin(lo, dim=-1).T, torch.amax(hi, dim=-1).T,
                      torch.zeros((nq, 2), dtype=tris_op.dtype,
                                  device=tris_op.device)], dim=1).contiguous()


def stream_sub_boxes(tri_packed, sub_t: int = STREAM_G):
    """The streamed sweep's gate boxes of a soup: sub_block_boxes of the
    Moller-Trumbore rows at sub_t, with an empty box (lo +inf, hi -inf)
    for each sub-block whose triangles are all points (e1 = e2 = 0: the
    padding, which no pair test accepts), so that no gate passes it.
    A resident soup (9 rows) gets a (1, 8) zero placeholder, as
    tri_mxu does for a streamed one."""
    if tri_packed.shape[0] != 16:
        return torch.zeros((1, 8), dtype=torch.float32,
                           device=tri_packed.device)
    boxes = sub_block_boxes(tri_packed, sub_t)
    point = (tri_packed[3:9] == 0).all(0).reshape(-1, sub_t).all(1)
    # filled on the device: no copy from the host
    empty = torch.full((8,), float("inf"), dtype=boxes.dtype,
                       device=boxes.device)
    empty[3:6] = -float("inf")
    empty[6:8] = 0.0
    return torch.where(point[:, None], empty, boxes).contiguous()


def stream_sweep_culled(tris_op, keys, idx_bits: int, rays,
                        any_hit: bool = False, cull_t: int = 128,
                        visits=None, workspace=None, sub_boxes=None,
                        tally=None):
    """K5-cull wrapper: stream_sweep on the 16-row Moller-Trumbore
    operand, gated by the boxes of its sub-blocks of cull_t triangles (a
    divisor of STREAM_T smaller than it): `sub_boxes`, (T / cull_t, 8),
    or when not given sub_block_boxes(tris_op, cull_t), computed here.

    Kernel: csrc/stream_sweep.cu, K5's walk and per-warp gate with the
    sub-blocks of STREAM_G triangles gated by the cull_t boxes that
    cover them, replacing pallas_mt.py `_mt_stream_kernel` with
    `n_sub > 1`.  The useful t starts from the ray's packed best, an
    upper bound of the final one, so no winner is skipped.  `visits`
    and `tally` count as K5's.  Culling is exact, so the plain version
    is the dense sweep.
    """
    _check_stream(tris_op, keys, idx_bits, rays)
    n_sub = cull_sub_blocks(cull_t)
    if n_sub == 1:
        raise ValueError(f"cull_t {cull_t}: expected a divisor of "
                         f"{STREAM_T} smaller than it")
    if rays.device.type == "cpu":
        return stream_sweep_plain(tris_op, rays, any_hit, use_bw=False)
    if sub_boxes is None:
        sub_boxes = sub_block_boxes(tris_op, cull_t)
    t, idx, err = _stream_launch(tris_op, keys, idx_bits, rays, any_hit,
                                 False, cull_t, sub_boxes, visits, tally,
                                 workspace)
    stream_sweep_culled.launches += 1
    _raise_on(err, "stream_sweep_culled")
    return t, idx


stream_sweep_culled.launches = 0


# ---------------------------------------------------------------------------
# K6: the 2-D culled sweep with barycentrics
# ---------------------------------------------------------------------------

def coarse_bounds(tile_bounds, n_tt: int):
    """FINE_T tile boxes grouped into n_tt TILE_T tiles (pallas_mt.py:
    1486-1491)."""
    if tile_bounds.shape[0] == n_tt:
        return tile_bounds
    tb = tile_bounds.reshape(n_tt, tile_bounds.shape[0] // n_tt, 8)
    return torch.cat([torch.amin(tb[:, :, 0:3], dim=1),
                      torch.amax(tb[:, :, 3:6], dim=1),
                      torch.zeros((n_tt, 2), dtype=tb.dtype,
                                  device=tb.device)], dim=1).contiguous()


def mt_sweep_plain(tris_packed, rays, any_hit: bool = False):
    """Dense Moller-Trumbore sweep with barycentrics: (t, idx, u, v),
    each (N,), the winner's raw u and v; idx -1, t +inf, u = v = 0 on a
    miss, the lowest index winning ties in t.  For any-hit only idx >= 0
    is meaningful."""
    del any_hit

    def test(c0, c1, o, d, mint, maxt):
        return _pair_test_uv(tris_packed[:, c0:c1], o, d, mint, maxt)

    return _dense_closest(tris_packed.shape[1], test, rays, n_extra=2)


def mt_sweep(tris_packed, tile_bounds, scene_bounds, rays,
             any_hit: bool = False, cull: bool = True, visits=None,
             workspace=None):
    """K6 wrapper: (t, idx, u, v), each (N,), for (8, N) rays against
    the (9, T) soup, T a multiple of TILE_T.  tile_bounds are the
    (T / FINE_T, 8) tile boxes (coarsened here to TILE_T tiles),
    scene_bounds (1, 8) [centre | half diagonal | ...].

    Kernel: csrc/mt_sweep.cu, replacing pallas_mt.py `_mt_kernel`
    (`mt_sweep`).  The visit order of each ray tile is its tiles sorted
    by entry bound (K1 on the coarsened bounds, then a stable argsort).
    Bound on the H100 by the pair tests' arithmetic.  K5's two
    launches: a plan cuts the positions of each order row that pass the
    first skyline into chunks of MT_S, and persistent blocks pull work
    items, one per chunk and quarter of the tiles (TILE_U triangles).
    An item reduces its rays' reach once and after each quarter it
    tests; tiles outside the reach or beyond the skyline cost a few
    compares and no barrier, and the scan stops at the first entry bound
    beyond the skyline.  The fold goes through the packed best ordered
    by t, the tile's position in the order, the index in the tile, and
    the last item of a ray tile recomputes the winner's u and v with the
    same pair test.  Within a tile ties keep the lowest index, across
    tiles the tile earlier in the order (the TPU kernel's fold), so idx
    can differ from the dense plain version only at exact ties in t.
    `visits` counts quarter tiles; the workspace is stream_workspace's.
    """
    _check_rays(rays)
    _check(tris_packed, "tris_packed", torch.float32, 2, rays.device)
    _check(tile_bounds, "tile_bounds", torch.float32, 2, rays.device)
    _check(scene_bounds, "scene_bounds", torch.float32, 2, rays.device)
    rows, T = tris_packed.shape
    n = rays.shape[1]
    if rows != 9 or T % TILE_T or T == 0:
        raise ValueError(f"tris_packed: expected (9, T) with T % {TILE_T} "
                         f"== 0, got {tuple(tris_packed.shape)}")
    n_tt = T // TILE_T
    if n_tt > 1 << 21:
        raise ValueError(f"tris_packed: {n_tt} tiles, the packed best "
                         f"holds {1 << 21}")
    if tile_bounds.shape[0] % n_tt or tile_bounds.shape[1] != 8:
        raise ValueError(f"tile_bounds: expected (k * {n_tt}, 8), got "
                         f"{tuple(tile_bounds.shape)}")
    if rays.device.type == "cpu":
        return mt_sweep_plain(tris_packed, rays, any_hit)
    if tris_packed.data_ptr() % 16:
        raise ValueError("tris_packed: the tile copies need 16-byte "
                         "alignment")
    n_rt = n // TILE_N
    tb = coarse_bounds(tile_bounds, n_tt)
    if cull and n_tt > 1:
        entry = entry_min(tb, rays)
        order = torch.argsort(entry, dim=1, stable=True).to(torch.int32)
    else:
        entry = torch.zeros((n_rt, n_tt), dtype=torch.float32,
                            device=rays.device)
        order = torch.arange(n_tt, dtype=torch.int32,
                             device=rays.device).expand(n_rt, n_tt)
    order = order.contiguous()
    outs = (torch.empty((n,), dtype=torch.float32, device=rays.device),
            torch.empty((n,), dtype=torch.int32, device=rays.device),
            torch.empty((n,), dtype=torch.float32, device=rays.device),
            torch.empty((n,), dtype=torch.float32, device=rays.device))
    workspace, ptrs = _stream_ptrs(workspace, n, rays.device)
    lib = cuda_build.load()
    err = _launch(
        lib.mt_sweep_launch, rays.device, tris_packed.data_ptr(), T,
        order.data_ptr(), entry.data_ptr(), tb.data_ptr(),
        scene_bounds.data_ptr(), n_tt, rays.data_ptr(), n,
        *(o.data_ptr() for o in outs), int(any_hit), int(cull),
        _visits_ptr(visits, n_rt, rays.device), *ptrs)
    mt_sweep.launches += 1
    _raise_on(err, "mt_sweep")
    return outs


mt_sweep.launches = 0


def launch_counters() -> dict:
    """The kernel wrappers of this module that count their launches,
    by name."""
    return {k: f for k, f in globals().items()
            if callable(f) and hasattr(f, "launches")}
