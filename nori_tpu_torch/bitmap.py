"""EXR / PNG image I/O.

Replaces src/bitmap.cpp:32-134 (OpenEXR read/write + sRGB PNG via stb).
No EXR library is available in this environment, so this is a
self-contained OpenEXR 2.0 scanline codec implemented from the public
file-format specification.  Read: float/half RGB channels under
NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A compression, increasing-Y line
order.  Write: NONE/RLE/ZIPS/ZIP/PXR24/PIZ, half (default, like the
reference's OpenEXR output) or float channels.  Matches the
reference's conventions: RGB channel naming on read (suffix match),
a "comments" attribute on write, and sRGB tonemapped 8-bit PNG output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from nori_tpu_torch.registry import NoriError
from nori_tpu_torch.core.color import np_to_srgb

_MAGIC = 20000630
_PXTYPE_UINT, _PXTYPE_HALF, _PXTYPE_FLOAT = 0, 1, 2
(_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ, _COMP_PXR24,
 _COMP_B44, _COMP_B44A) = range(8)
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_RLE: 1, _COMP_ZIPS: 1,
                    _COMP_ZIP: 16, _COMP_PIZ: 32, _COMP_PXR24: 16,
                    _COMP_B44: 32, _COMP_B44A: 32}
_COMP_NAMES = {"none": _COMP_NONE, "rle": _COMP_RLE, "zips": _COMP_ZIPS,
               "zip": _COMP_ZIP, "piz": _COMP_PIZ, "pxr24": _COMP_PXR24,
               "b44": _COMP_B44, "b44a": _COMP_B44A}


# ---------------------------------------------------------------------------
# ZIP predictor + byte-reorder transform (per the OpenEXR spec)
# ---------------------------------------------------------------------------

def _zip_postdecode(data: bytes) -> np.ndarray:
    t = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
    # undo delta predictor: stored d[i] = t[i]-t[i-1]+384 (mod 256)
    t[1:] -= 384
    t = np.cumsum(t) & 0xFF
    # undo reorder: first half = even positions, second half = odd
    n = t.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _zip_preencode(raw: np.ndarray) -> bytes:
    n = raw.shape[0]
    half = (n + 1) // 2
    t = np.empty(n, dtype=np.uint8)
    t[:half] = raw[0::2]
    t[half:] = raw[1::2]
    d = t.astype(np.int32)
    d[1:] = (d[1:] - d[:-1] + 384) & 0xFF
    return d.astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# RLE codec (ImfRle semantics; shares the ZIP predictor/reorder transform)
# ---------------------------------------------------------------------------

_RLE_MIN_RUN = 3
_RLE_MAX_RUN = 127


def _rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        i += 1
        if c > 127:          # negative int8: -(c-256) literal bytes
            count = 256 - c
            out += data[i:i + count]
            i += count
        else:                # c+1 copies of the next byte
            out += data[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


def _rle_encode(data: bytes) -> bytes:
    out = bytearray()
    n = len(data)
    i = 0
    lit_start = 0

    def flush_literals(end):
        j = lit_start
        while j < end:
            cnt = min(end - j, _RLE_MAX_RUN)
            out.append(256 - cnt)
            out.extend(data[j:j + cnt])
            j += cnt

    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] \
                and run < _RLE_MAX_RUN:
            run += 1
        if run >= _RLE_MIN_RUN:
            flush_literals(i)
            out.append(run - 1)
            out.append(data[i])
            i += run
            lit_start = i
        else:
            i += run
    flush_literals(n)
    return bytes(out)


# ---------------------------------------------------------------------------
# PXR24 codec (ImfPxr24Compressor semantics): per (scanline, channel)
# run, pixels are difference-coded and split into big-endian byte
# planes (FLOAT keeps the top 24 bits of the f32 pattern), then zlib.
# ---------------------------------------------------------------------------

def _pxr24_planes(ptype: int) -> int:
    return {_PXTYPE_UINT: 4, _PXTYPE_HALF: 2, _PXTYPE_FLOAT: 3}[ptype]


def _pxr24_decode(data: bytes, channels, width: int, nlines: int) -> bytes:
    """channels: list of (name, pixel_type_int, numpy dtype)."""
    tmp = zlib.decompress(data)
    pos = 0
    out = bytearray()
    for ln in range(nlines):
        for name, ptype, dt in channels:
            k = _pxr24_planes(ptype)
            planes = [
                np.frombuffer(tmp, np.uint8, width, pos + j * width)
                .astype(np.uint32)
                for j in range(k)
            ]
            pos += k * width
            diff = planes[0]
            for p in planes[1:]:
                diff = (diff << 8) | p
            pix = np.cumsum(diff.astype(np.uint64)).astype(np.uint32) \
                & ((1 << (8 * k)) - 1)
            if ptype == _PXTYPE_FLOAT:
                out += (pix << 8).astype("<u4").tobytes()
            elif ptype == _PXTYPE_HALF:
                out += pix.astype("<u2").tobytes()
            else:
                out += pix.astype("<u4").tobytes()
    return bytes(out)


def _pxr24_encode(raw: bytes, channels, width: int, nlines: int) -> bytes:
    pos = 0
    tmp = bytearray()
    for ln in range(nlines):
        for name, ptype, dt in channels:
            k = _pxr24_planes(ptype)
            if ptype == _PXTYPE_FLOAT:
                # floatToFloat24 semantics: round-half-to-even at the
                # dropped byte, clamp so rounding cannot overflow into
                # Inf, preserve Inf, keep NaN a NaN (nonzero mantissa)
                i = np.frombuffer(raw, "<u4", width, pos).astype(
                    np.uint64)
                s = i & 0x80000000
                e = i & 0x7F800000
                m = i & 0x007FFFFF
                special = e == 0x7F800000
                spec24 = (s | e | np.where(m != 0, 0x007FFFFF, 0)
                          .astype(np.uint64)) >> 8
                r = i + 0x7F + ((i >> 8) & 1)
                overflow = (r & 0x7F800000) == 0x7F800000
                r = np.where(overflow & ~special, s | 0x7F7FFFFF, r) \
                    .astype(np.uint64)
                pix = np.where(special, spec24, r >> 8).astype(np.uint32)
                pos += 4 * width
            elif ptype == _PXTYPE_HALF:
                pix = np.frombuffer(raw, "<u2", width, pos).astype(
                    np.uint32)
                pos += 2 * width
            else:
                pix = np.frombuffer(raw, "<u4", width, pos).astype(
                    np.uint32)
                pos += 4 * width
            diff = pix.copy()
            diff[1:] -= pix[:-1]
            diff &= (1 << (8 * k)) - 1
            for j in range(k):
                tmp += ((diff >> (8 * (k - 1 - j))) & 0xFF).astype(
                    np.uint8).tobytes()
    return zlib.compress(bytes(tmp), 6)


# ---------------------------------------------------------------------------
# B44 / B44A decode (ImfB44Compressor semantics): HALF channels as 4x4
# pixel blocks of 14 bytes (or 3 bytes for flat B44A blocks); other
# channel types stored raw.
# ---------------------------------------------------------------------------

def _b44_unpack14(b: np.ndarray) -> np.ndarray:
    """(K, 14) uint8 blocks -> (K, 16) uint16 (row-major 4x4)."""
    b = b.astype(np.uint32)
    s = np.zeros((b.shape[0], 16), np.int64)
    shift = (b[:, 2] >> 2).astype(np.int64)
    bias = np.int64(0x20) << shift
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    s[:, 4] = s[:, 0] + ((((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F)
                         << shift) - bias
    s[:, 8] = s[:, 4] + ((((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F)
                         << shift) - bias
    s[:, 12] = s[:, 8] + ((b[:, 4] & 0x3F) << shift) - bias
    s[:, 1] = s[:, 0] + ((b[:, 5] >> 2) << shift) - bias
    s[:, 5] = s[:, 4] + ((((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F)
                         << shift) - bias
    s[:, 9] = s[:, 8] + ((((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F)
                         << shift) - bias
    s[:, 13] = s[:, 12] + ((b[:, 7] & 0x3F) << shift) - bias
    s[:, 2] = s[:, 1] + ((b[:, 8] >> 2) << shift) - bias
    s[:, 6] = s[:, 5] + ((((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F)
                         << shift) - bias
    s[:, 10] = s[:, 9] + ((((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F)
                          << shift) - bias
    s[:, 14] = s[:, 13] + ((b[:, 10] & 0x3F) << shift) - bias
    s[:, 3] = s[:, 2] + ((b[:, 11] >> 2) << shift) - bias
    s[:, 7] = s[:, 6] + ((((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F)
                         << shift) - bias
    s[:, 11] = s[:, 10] + ((((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F)
                           << shift) - bias
    s[:, 15] = s[:, 14] + ((b[:, 13] & 0x3F) << shift) - bias
    s &= 0xFFFF
    # undo the half transform: sign-flagged values come back directly,
    # others were stored complemented
    s16 = s.astype(np.uint16)
    return np.where(s16 & 0x8000, s16 & 0x7FFF,
                    (~s16) & np.uint16(0xFFFF)).astype(np.uint16)


def _b44_decode(data: bytes, channels, width: int, nlines: int) -> bytes:
    """channels: list of (name, pixel_type_int, numpy dtype)."""
    planes = []
    pos = 0
    for name, ptype, dt in channels:
        if ptype != _PXTYPE_HALF:
            n = width * nlines * dt.itemsize
            planes.append(np.frombuffer(data, np.uint8, n, pos)
                          .reshape(nlines, width * dt.itemsize))
            pos += n
            continue
        nbx = (width + 3) // 4
        nby = (nlines + 3) // 4
        blocks = np.zeros((nby * nbx, 16), np.uint16)
        raw_blocks = []
        flat = []
        order = []
        for bi in range(nby * nbx):
            marker = data[pos + 2] if pos + 2 < len(data) else 0
            if marker >= (13 << 2):   # 3-byte flat block (B44A)
                v = (data[pos] << 8) | data[pos + 1]
                flat.append((bi, v))
                pos += 3
            else:
                raw_blocks.append(data[pos:pos + 14])
                order.append(bi)
                pos += 14
        if raw_blocks:
            arr = np.frombuffer(b"".join(raw_blocks), np.uint8)
            arr = arr.reshape(len(raw_blocks), 14)
            blocks[np.asarray(order)] = _b44_unpack14(arr)
        for bi, v in flat:
            s = np.uint16(v)
            s = (s & 0x7FFF) if (s & 0x8000) else ((~s) & 0xFFFF)
            blocks[bi, :] = s
        # lay the 4x4 blocks out as the (padded) channel image
        b4 = blocks.reshape(nby, nbx, 4, 4)
        img = b4.transpose(0, 2, 1, 3).reshape(nby * 4, nbx * 4)
        planes.append(
            img[:nlines, :width].astype("<u2").view(np.uint8)
            .reshape(nlines, width * 2))
    out = bytearray()
    for ln in range(nlines):
        for plane in planes:
            out += plane[ln].tobytes()
    return bytes(out)


#: B44 delta edges in bitstream order: (predecessor, successor) pixel
#: indices within the row-major 4x4 block.  Stream order is a valid
#: topological order (every predecessor is quantized before its
#: successors), which makes the sequential quantization below exact.
_B44_EDGES = [
    (0, 4), (4, 8), (8, 12),
    (0, 1), (4, 5), (8, 9), (12, 13),
    (1, 2), (5, 6), (9, 10), (13, 14),
    (2, 3), (6, 7), (10, 11), (14, 15),
]


def _b44_pack14(t: np.ndarray) -> np.ndarray:
    """(K, 16) transformed uint16 4x4 blocks -> (K, 14) uint8 B44.

    The inverse of _b44_unpack14's bitstream: s[0] (16 bits) | shift
    (6 bits) | 15 running 6-bit deltas, each decoded as
    s[succ] = s[pred] + (d - 0x20) << shift.  The quantization is
    sequential (each delta measured against the QUANTIZED
    predecessor), so reconstruction error never accumulates past
    +-(1 << shift) / 2 per value; shift is raised per block until all
    quantized deltas fit the signed 6-bit range.
    """
    K = t.shape[0]
    ti = t.astype(np.int64)
    # smallest shift whose range covers the raw deltas, then verify
    # under sequential quantization and bump where rounding overflows
    raw_max = np.zeros((K,), np.int64)
    for p, s in _B44_EDGES:
        raw_max = np.maximum(raw_max, np.abs(ti[:, s] - ti[:, p]))
    shift = np.zeros((K,), np.int64)
    for _ in range(13):
        fits = raw_max <= (np.int64(31) << shift)
        shift = np.where(fits, shift, shift + 1)
    shift = np.minimum(shift, 12)

    for _ in range(13):
        rec = np.zeros((K, 16), np.int64)
        rec[:, 0] = ti[:, 0]
        dq = np.zeros((K, 15), np.int64)
        ok = np.ones((K,), bool)
        half = np.int64(1) << np.maximum(shift - 1, 0)
        half = np.where(shift > 0, half, 0)
        for ei, (p, s) in enumerate(_B44_EDGES):
            ideal = ti[:, s] - rec[:, p]
            d = (ideal + half) >> shift     # round-to-nearest
            ok &= (d >= -32) & (d <= 31)
            d = np.clip(d, -32, 31)
            v = rec[:, p] + (d << shift)
            # the decoder wraps mod 2^16; keep rec in range instead
            over = v > 0xFFFF
            d = np.where(over, (0xFFFF - rec[:, p]) >> shift, d)
            under = v < 0
            d = np.where(under, -(rec[:, p] >> shift), d)
            d = np.clip(d, -32, 31)
            rec[:, s] = rec[:, p] + (d << shift)
            dq[:, ei] = d + 0x20
        if ok.all():
            break
        shift = np.where(ok, shift, np.minimum(shift + 1, 12))

    # bitstream: s0(16) | shift(6) | d1..d15 (6 each) = 112 bits
    bits = np.zeros((K, 14), np.uint8)
    bits[:, 0] = (ti[:, 0] >> 8) & 0xFF
    bits[:, 1] = ti[:, 0] & 0xFF
    acc = shift.copy()          # running bit accumulator, 6 bits live
    nacc = np.full((K,), 6, np.int64)
    out_i = 2
    for ei in range(15):
        acc = (acc << 6) | dq[:, ei]
        nacc = nacc + 6
        while out_i < 14 and (nacc >= 8).all():
            nacc -= 8
            bits[:, out_i] = (acc >> nacc) & 0xFF
            acc &= (np.int64(1) << nacc) - 1
            out_i += 1
    return bits


def _b44_transform(h16: np.ndarray) -> np.ndarray:
    """half bits -> monotonic u16 (ImfB44Compressor convertToLinear):
    inf/nan flush to 0x8000; negatives complement; positives set the
    top bit.  Inverse of the final step of _b44_unpack14."""
    t = np.where(
        (h16 & 0x7C00) == 0x7C00, np.uint16(0x8000),
        np.where(h16 & 0x8000, (~h16) & np.uint16(0xFFFF),
                 h16 | np.uint16(0x8000)))
    return t.astype(np.uint16)


def _b44_encode(raw: bytes, channels, width: int, nlines: int,
                flat_blocks: bool) -> bytes:
    """Encode scanline-interleaved raw bytes as B44 (flat_blocks=False)
    or B44A (3-byte blocks for constant 4x4 tiles).  channels: list of
    (name, pixel_type_int, numpy dtype); non-HALF channels are stored
    raw, matching _b44_decode."""
    bytes_per_px = sum(dt.itemsize for _, _, dt in channels)
    assert len(raw) == bytes_per_px * width * nlines
    arr = np.frombuffer(raw, np.uint8).reshape(nlines, -1)
    out = bytearray()
    col = 0
    for name, ptype, dt in channels:
        n = width * dt.itemsize
        plane = arr[:, col:col + n]
        col += n
        if ptype != _PXTYPE_HALF:
            out += plane.tobytes()
            continue
        h16 = plane.reshape(nlines, width, dt.itemsize)
        h16 = np.ascontiguousarray(h16).view("<u2")[:, :, 0]
        t = _b44_transform(h16.astype(np.uint16))
        # pad to 4x4 multiples by edge replication (flat extensions
        # compress well and decode crops them away)
        py = (-nlines) % 4
        px = (-width) % 4
        t = np.pad(t, ((0, py), (0, px)), mode="edge")
        nby, nbx = t.shape[0] // 4, t.shape[1] // 4
        blocks = (t.reshape(nby, 4, nbx, 4).transpose(0, 2, 1, 3)
                  .reshape(nby * nbx, 16))
        packed = _b44_pack14(blocks)
        flat = np.all(blocks == blocks[:, :1], axis=1) if flat_blocks \
            else np.zeros((nby * nbx,), bool)
        for bi in range(nby * nbx):
            if flat[bi]:
                v = int(blocks[bi, 0])
                out += bytes([(v >> 8) & 0xFF, v & 0xFF, 0xFC])
            else:
                out += packed[bi].tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _read_attr_string(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _exr_header(buf: bytes, filename: str):
    """Parse an EXR header: (channels [(name, pixel_type)], compression,
    dataWindow, position of the line offset table)."""
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise NoriError(f"'{filename}': not an OpenEXR file")
    if version & 0x200:
        raise NoriError(f"'{filename}': tiled EXR not supported")

    pos = 8
    channels = []  # list of (name, pixel_type)
    compression = _COMP_NONE
    data_window = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_attr_string(buf, pos)
        atype, pos = _read_attr_string(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_attr_string(payload, cpos)
                ptype, _plin, _xs, _ys = struct.unpack_from(
                    "<iB3xii", payload, cpos
                )
                cpos += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)
    return channels, compression, data_window, pos


def exr_pixel_types(filename: str) -> dict:
    """{channel name: "uint" | "half" | "float"} of an EXR's channels:
    the precision its pixels are stored in."""
    with open(filename, "rb") as f:
        buf = f.read()
    names = {_PXTYPE_UINT: "uint", _PXTYPE_HALF: "half",
             _PXTYPE_FLOAT: "float"}
    return {name: names[pt] for name, pt in _exr_header(buf, filename)[0]}


def read_exr(filename: str) -> np.ndarray:
    """Read an EXR into an (H, W, 3) float32 array of linear RGB.

    Mirrors Bitmap::Bitmap(filename) (src/bitmap.cpp:32-79): channels
    whose names equal or end with R/G/B are selected; missing channels
    raise.
    """
    with open(filename, "rb") as f:
        buf = f.read()
    channels, compression, data_window, pos = _exr_header(buf, filename)
    if data_window is None:
        raise NoriError(f"'{filename}': missing dataWindow")
    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1

    if compression not in _LINES_PER_BLOCK:
        raise NoriError(
            f"'{filename}': unsupported compression {compression}"
        )
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (height + lines_per_block - 1) // lines_per_block

    # channel -> rgb slot, by exact or suffix match (src/bitmap.cpp:49-63)
    slot = {}
    for ci, (cname, ptype) in enumerate(channels):
        for want, si in (("R", 0), ("G", 1), ("B", 2)):
            if cname == want or cname.endswith("." + want):
                slot[ci] = si
    if len(slot) < 3:
        raise NoriError(f"'{filename}': could not find RGB channels {channels}")

    chan_dtypes = [
        np.dtype(np.float16) if pt == _PXTYPE_HALF else np.dtype(np.float32)
        for _, pt in channels
    ]
    if any(pt == _PXTYPE_UINT for _, pt in channels):
        raise NoriError(f"'{filename}': UINT channels not supported")
    bytes_per_px = sum(dt.itemsize for dt in chan_dtypes)

    # skip line offset table
    offsets = struct.unpack_from(f"<{num_blocks}q", buf, pos)
    img = np.zeros((height, width, 3), dtype=np.float32)

    chan3 = [(n, pt, dt)
             for (n, pt), dt in zip(channels, chan_dtypes)]
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        block_y0 = y - ymin
        nlines = min(lines_per_block, height - block_y0)
        raw_size = bytes_per_px * width * nlines
        if size >= raw_size:
            raw = data  # stored uncompressed (codec didn't shrink it)
        elif compression == _COMP_PIZ:
            from nori_tpu_torch.exr_piz import piz_uncompress

            raw = piz_uncompress(
                data, [(n, dt) for (n, _), dt in zip(channels, chan_dtypes)],
                width, nlines,
            )
        elif compression in (_COMP_ZIP, _COMP_ZIPS):
            raw = _zip_postdecode(zlib.decompress(data)).tobytes()
        elif compression == _COMP_RLE:
            raw = _zip_postdecode(_rle_decode(data)).tobytes()
        elif compression == _COMP_PXR24:
            raw = _pxr24_decode(data, chan3, width, nlines)
        elif compression in (_COMP_B44, _COMP_B44A):
            raw = _b44_decode(data, chan3, width, nlines)
        else:
            raw = data
        rpos = 0
        for ln in range(nlines):
            for ci, dt in enumerate(chan_dtypes):
                n = width * dt.itemsize
                vals = np.frombuffer(raw, dtype=dt, count=width, offset=rpos)
                rpos += n
                if ci in slot:
                    img[block_y0 + ln, :, slot[ci]] = vals.astype(np.float32)
    return img


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + atype.encode() + b"\x00"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr_channels(filename: str, channels: dict,
                       compression: str = "zip"):
    """Write an arbitrary channel set as a scanline EXR.

    channels: dict name -> (H, W) array.  float16 arrays are stored as
    HALF, anything else as FLOAT.  Channels are stored in the spec's
    alphabetical order regardless of dict order.  compression:
    none | rle | zips | zip | pxr24 | piz | b44 | b44a.  This is the
    general writer behind write_exr; the reference's Bitmap only ever
    writes RGB (src/bitmap.cpp:81-108), but its OpenEXR library writes
    any channel list — this keeps that capability.
    """
    if not channels:
        raise NoriError("write_exr_channels: empty channel set")
    if compression not in _COMP_NAMES:
        raise NoriError(f"write_exr: unknown compression '{compression}'")
    comp_id = _COMP_NAMES[compression]
    names = sorted(channels)
    planes = []
    shape = None
    for n in names:
        a = np.asarray(channels[n])
        dt = np.dtype(np.float16) if a.dtype == np.float16 \
            else np.dtype(np.float32)
        a = a.astype(dt)
        if a.ndim != 2:
            raise NoriError(f"write_exr_channels: '{n}' must be (H, W)")
        if shape is None:
            shape = a.shape
        elif a.shape != shape:
            raise NoriError("write_exr_channels: mismatched channel shapes")
        ptype = _PXTYPE_HALF if dt == np.float16 else _PXTYPE_FLOAT
        planes.append((n, ptype, dt, a))
    h, w = shape

    chlist = b""
    for n, ptype, dt, _ in planes:
        chlist += n.encode("latin-1") + b"\x00" + struct.pack(
            "<iB3xii", ptype, 0, 1, 1)
    chlist += b"\x00"

    header = struct.pack("<ii", _MAGIC, 2)
    header += _attr("channels", "chlist", chlist)
    header += _attr("comments", "string", b"Generated by nori_tpu")
    header += _attr("compression", "compression", bytes([comp_id]))
    header += _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    chan_meta = [(n, ptype, dt) for n, ptype, dt, _ in planes]
    lines_per_block = _LINES_PER_BLOCK[comp_id]
    num_blocks = (h + lines_per_block - 1) // lines_per_block
    chunks = []
    for b in range(num_blocks):
        y0 = b * lines_per_block
        nlines = min(lines_per_block, h - y0)
        # per scanline: each channel's row, channels in stored order
        raw = np.concatenate([
            np.ascontiguousarray(a[y0:y0 + nlines]).view(np.uint8)
            .reshape(nlines, -1)
            for _, _, _, a in planes
        ], axis=1).ravel()
        if comp_id in (_COMP_ZIP, _COMP_ZIPS):
            comp = zlib.compress(_zip_preencode(raw), 6)
        elif comp_id == _COMP_RLE:
            comp = _rle_encode(_zip_preencode(raw))
        elif comp_id == _COMP_PXR24:
            comp = _pxr24_encode(raw.tobytes(), chan_meta, w, nlines)
        elif comp_id == _COMP_PIZ:
            from nori_tpu_torch.exr_piz import piz_compress

            comp = piz_compress(
                raw.tobytes(), [(n, dt) for n, _, dt in chan_meta],
                w, nlines)
        elif comp_id in (_COMP_B44, _COMP_B44A):
            comp = _b44_encode(raw.tobytes(), chan_meta, w, nlines,
                               flat_blocks=(comp_id == _COMP_B44A))
        else:
            comp = raw.tobytes()
        if len(comp) >= raw.nbytes:
            comp = raw.tobytes()
        chunks.append((y0, comp))

    table_pos = len(header)
    data_pos = table_pos + 8 * num_blocks
    offsets = []
    cur = data_pos
    for y0, comp in chunks:
        offsets.append(cur)
        cur += 8 + len(comp)

    with open(filename, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{num_blocks}q", *offsets))
        for y0, comp in chunks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)


def write_exr(filename: str, img: np.ndarray, half: bool = True,
              compression: str = "zip"):
    """Write (H, W, 3) linear RGB as a scanline EXR.

    Writes R/G/B channels (stored alphabetically B, G, R per the spec)
    plus a "comments" attribute like the reference
    (src/bitmap.cpp:96 "Generated by Nori").  Default is half-float
    ZIP, matching the reference's OpenEXR output
    (src/bitmap.cpp:81-108); pass half=False for lossless float32.
    compression: none | rle | zips | zip | pxr24 | piz | b44 | b44a.
    """
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise NoriError(f"write_exr: expected (H, W, 3), got {img.shape}")
    dt = np.float16 if half else np.float32
    write_exr_channels(
        filename,
        {"R": img[:, :, 0].astype(dt), "G": img[:, :, 1].astype(dt),
         "B": img[:, :, 2].astype(dt)},
        compression=compression)


def write_png(filename: str, img: np.ndarray):
    """sRGB-tonemap linear RGB to an 8-bit PNG (src/bitmap.cpp:110-134)."""
    from PIL import Image

    img = np.asarray(img, dtype=np.float32)
    srgb = np_to_srgb(np.clip(img, 0.0, None))
    out = np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(out, mode="RGB").save(filename)
