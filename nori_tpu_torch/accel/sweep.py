"""Ray/triangle sweep kernels and their plain PyTorch versions.

Counterpart of `nori_tpu/accel/pallas_mt.py` for the kernels on the
persistent wavefront's path:

  K1 `entry_min`       <- `_entry_kernel`       (pallas_mt.py:896)
  K2 `resident_sweep`  <- `_mt_resident_kernel` (pallas_mt.py:291)
  K3 `lane_keys`       <- `_lane_key_kernel`    (pallas_mt.py:982)
  K5 `stream_sweep`    <- `_mt_stream_kernel`   (pallas_mt.py:526)

Each wrapper launches its CUDA kernel (nori_tpu_torch/csrc/) for
tensors on a CUDA device and uses its plain version, defined beside it,
only for tensors on the CPU; there is no fallback from a failed kernel.
Each counts its kernel launches in a plain integer attribute
(`entry_min.launches`, ...), which a run can reset and read to show
that its main path went through the kernels.

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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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


def entry_min(tile_bounds, rays):
    """K1 wrapper: (n_tt, 8) bounds, (8, N) rays -> (n_rt, n_tt) f32.

    Kernel: csrc/entry_min.cu, replacing pallas_mt.py `_entry_kernel`.
    Bound on the H100 by the slab-test arithmetic (n_rays * n_tt
    tests); one block per ray tile keeps its rays in shared memory and
    each thread owns whole output entries, so no reduction is needed.
    """
    _check_rays(rays)
    _check(tile_bounds, "tile_bounds", torch.float32, 2, rays.device)
    if tile_bounds.shape[1] != 8:
        raise ValueError("tile_bounds: expected (n_tt, 8)")
    if rays.device.type == "cpu":
        return entry_min_plain(tile_bounds, rays)
    n_tt, n = tile_bounds.shape[0], rays.shape[1]
    out = torch.empty((n // TILE_N, n_tt), dtype=torch.float32,
                      device=rays.device)
    lib = cuda_build.load()
    err = lib.entry_min_launch(tile_bounds.data_ptr(), rays.data_ptr(),
                               out.data_ptr(), n_tt, n, _stream(rays.device))
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
    n_tt = tile_bounds.shape[0]
    idx_bits = max(1, (n_tt - 1).bit_length())
    mask = (1 << idx_bits) - 1
    bits = entry_min(tile_bounds, rays).view(torch.int32)
    idx = torch.arange(n_tt, dtype=torch.int32, device=rays.device)
    keys = torch.sort((bits & ~mask) | idx[None, :], dim=1).values
    return keys.contiguous(), idx_bits


# ---------------------------------------------------------------------------
# K2: resident sweep (closest or any hit)
# ---------------------------------------------------------------------------

def _pair_test(tris, o, d, mint, maxt):
    """Rays (n, 1) columns against a (rows, C) operand block; returns
    (hit, t) of shape (n, C).  The expressions round as the kernel's
    (left-to-right sums, no fused multiply-add)."""
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
    return hit, t


def resident_sweep_plain(tris_op, rays, any_hit: bool = False):
    """Dense sweep of every live ray against every triangle, chunked
    over triangles.  Returns (t (N,) f32, idx (N,) int32), idx -1 on a
    miss, the lowest index winning ties in t.  The kernel's candidate
    walk and skyline exit only skip tiles that cannot hold a closer hit,
    so the dense sweep gives the same closest hit.  For any-hit only
    idx >= 0 is meaningful (here it is the closest hit)."""
    del any_hit
    n = rays.shape[1]
    T = tris_op.shape[1]
    dev = rays.device
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    idx_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sel = torch.nonzero(rays[6] <= rays[7]).squeeze(1)
    m = sel.shape[0]
    if m == 0:
        return t_out, idx_out
    r = rays[:, sel]
    o = (r[0][:, None], r[1][:, None], r[2][:, None])
    d = (r[3][:, None], r[4][:, None], r[5][:, None])
    mint, maxt = r[6][:, None], r[7][:, None]
    chunk = max(FINE_T, _PLAIN_PAIRS // m // FINE_T * FINE_T)
    best_t = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((m,), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, T, chunk):
        hit, t = _pair_test(tris_op[:, c0:c0 + chunk], o, d, mint, maxt)
        tmin, j = torch.min(torch.where(hit, t, float("inf")), dim=1)
        better = tmin < best_t   # strict: earlier chunks win ties
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, j + c0, best_i)
    t_out[sel] = best_t
    idx_out[sel] = best_i.to(torch.int32)
    return t_out, idx_out


def resident_sweep(tris_op, keys, idx_bits: int, rays,
                   any_hit: bool = False):
    """K2 wrapper: (t (N,) f32, idx (N,) int32) for (8, N) rays against
    the (9, T) or (12, T) operand, walking `keys` from
    ray_tile_entry_keys.

    Kernel: csrc/resident_sweep.cu, replacing pallas_mt.py
    `_mt_resident_kernel`.  Bound on the H100 by the pair-test
    arithmetic and the per-visit block reduction; one block per ray
    tile stages each visited 128-triangle tile in shared memory and
    stops at the skyline.  The plain version (CPU tensors) sweeps
    densely and does not read the keys.
    """
    _check_rays(rays)
    _check(tris_op, "tris_op", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    rows, T = tris_op.shape
    n = rays.shape[1]
    if rows not in (9, 12) or T % FINE_T:
        raise ValueError(f"tris_op: expected (9|12, T) with T % {FINE_T} "
                         f"== 0, got {tuple(tris_op.shape)}")
    n_tt = T // FINE_T
    if tuple(keys.shape) != (n // TILE_N, n_tt):
        raise ValueError(f"keys: expected ({n // TILE_N}, {n_tt}), got "
                         f"{tuple(keys.shape)}")
    # tile indices sit below the entry bits' low mantissa (< 23 bits)
    if not 1 <= idx_bits <= 22 or (1 << idx_bits) < n_tt:
        raise ValueError(f"idx_bits {idx_bits} cannot index {n_tt} tiles")
    if rays.device.type == "cpu":
        return resident_sweep_plain(tris_op, rays, any_hit)
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = lib.resident_sweep_launch(
        tris_op.data_ptr(), rows, T, keys.data_ptr(), keys.shape[1],
        idx_bits, rays.data_ptr(), n, t.data_ptr(), idx.data_ptr(),
        int(any_hit), _stream(rays.device))
    resident_sweep.launches += 1
    _raise_on(err, "resident_sweep")
    return t, idx


resident_sweep.launches = 0


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


def lane_keys(tile_bounds, rays):
    """K3 wrapper: (n_tt, 8) bounds, (8, N) rays -> (key1, key2), each
    (N,) int32.

    Kernel: csrc/lane_keys.cu, replacing pallas_mt.py
    `_lane_key_kernel`.  Bound on the H100 by the slab tests (n_lanes *
    n_tt); one thread per lane walks the tile boxes, staged once per
    block in shared memory, and builds the masks as integers.
    """
    _check_rays(rays)
    _check(tile_bounds, "tile_bounds", torch.float32, 2, rays.device)
    n_tt, n = tile_bounds.shape[0], rays.shape[1]
    if tile_bounds.shape[1] != 8:
        raise ValueError(f"tile_bounds: expected (n_tt, 8), got "
                         f"{tuple(tile_bounds.shape)}")
    if rays.device.type == "cpu":
        return lane_keys_plain(tile_bounds, rays)
    k1 = torch.empty((n,), dtype=torch.int32, device=rays.device)
    k2 = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = lib.lane_keys_launch(
        tile_bounds.data_ptr(), n_tt, -(-n_tt // 128) * 128,
        rays.data_ptr(), n, k1.data_ptr(), k2.data_ptr(),
        _stream(rays.device))
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


def stream_sweep(tris_op, keys, idx_bits: int, rays, any_hit: bool = False,
                 use_bw: bool = True):
    """K5 wrapper: (t (N,) f32, idx (N,) int32) for (8, N) rays against
    the (16, T) streamed operand, walking `keys` from
    ray_tile_entry_keys on the (T / STREAM_T, 8) slab bounds.  use_bw
    says which rows the operand holds (with 16 rows its shape cannot).

    Kernel: csrc/stream_sweep.cu, replacing pallas_mt.py
    `_mt_stream_kernel`.  Bound on the H100 by the pair tests over
    each visited 512-triangle slab and the slab copies (which of the
    two dominates is not settled); one block per ray tile stages the
    slabs' read rows through a cp.async double buffer, the copy of the
    next slab overlapping the test of this one.  The plain version (CPU
    tensors) sweeps densely and does not read the keys.
    """
    _check_rays(rays)
    _check(tris_op, "tris_op", torch.float32, 2, rays.device)
    _check(keys, "keys", torch.int32, 2, rays.device)
    rows, T = tris_op.shape
    n = rays.shape[1]
    if rows != 16 or T % STREAM_T or T == 0:
        raise ValueError(f"tris_op: expected (16, T) with T % {STREAM_T} "
                         f"== 0, got {tuple(tris_op.shape)}")
    n_tt = T // STREAM_T
    if tuple(keys.shape) != (n // TILE_N, n_tt):
        raise ValueError(f"keys: expected ({n // TILE_N}, {n_tt}), got "
                         f"{tuple(keys.shape)}")
    if not 1 <= idx_bits <= 22 or (1 << idx_bits) < n_tt:
        raise ValueError(f"idx_bits {idx_bits} cannot index {n_tt} slabs")
    if rays.device.type == "cpu":
        return stream_sweep_plain(tris_op, rays, any_hit, use_bw)
    if tris_op.data_ptr() % 16:
        raise ValueError("tris_op: the slab copies need 16-byte alignment")
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    lib = cuda_build.load()
    err = lib.stream_sweep_launch(
        tris_op.data_ptr(), int(use_bw), T, keys.data_ptr(), n_tt,
        idx_bits, rays.data_ptr(), n, t.data_ptr(), idx.data_ptr(),
        int(any_hit), _stream(rays.device))
    stream_sweep.launches += 1
    _raise_on(err, "stream_sweep")
    return t, idx


stream_sweep.launches = 0
