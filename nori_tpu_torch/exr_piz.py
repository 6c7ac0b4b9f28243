"""PIZ (wavelet + Huffman) codec for OpenEXR scanline chunks.

Implements both sides of the PIZ codec from the public OpenEXR format
specification (ImfPizCompressor/ImfHuf/ImfWav semantics):

  chunk := u16 minNonZero, u16 maxNonZero,
           u8 bitmap[maxNonZero - minNonZero + 1],
           i32 compressedLength, huffman-coded data
  decode pipeline := huffman decode -> per-channel 2D wavelet decode ->
              LUT expansion -> scanline interleave
  encode pipeline := the exact mirror (forward LUT -> wavelet ->
              canonical Huffman)

FLOAT (and UINT) channels contribute `itemsize/2` u16 words per pixel;
each word plane is wavelet-transformed SEPARATELY with a horizontal
stride of `size` words, matching ImfPizCompressor's per-j wav2 calls.

Used by nori_tpu_torch.bitmap for compression type 4 (e.g. the fork's stored
reference image python/living-room_final.exr).  Pure numpy/python;
speed is adequate for one-off reference reads/writes.
"""

from __future__ import annotations

import struct

import numpy as np

BITMAP_SIZE = 8192
USHORT_RANGE = 1 << 16
HUF_ENCBITS = 16
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN
A_OFFSET = 1 << 15
MOD_MASK = (1 << 16) - 1


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(reader: _BitReader, im: int, iM: int) -> np.ndarray:
    """Code lengths with zero-run escapes (hufUnpackEncTable)."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = reader.get_bits(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = reader.get_bits(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code assignment (hufCanonicalCodeTable)."""
    n = np.zeros(59, np.int64)
    for l in lengths:
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros_like(lengths)
    for sym in range(len(lengths)):
        l = lengths[sym]
        if l > 0:
            codes[sym] = n[l]
            n[l] += 1
    return codes


HUF_DECBITS = 14


def _huf_decode_fast(data: bytes, im: int, iM: int, nbits: int,
                     lengths: np.ndarray, codes: np.ndarray,
                     n_out: int) -> np.ndarray:
    """Hybrid table decode like hufBuildDecTable/hufDecode: a
    2^14-entry fast table for codes <= 14 bits, plus per-prefix lists
    searched linearly for longer codes."""
    used = lengths > 0
    if not used.any():
        return np.zeros(n_out, np.uint16)

    size = 1 << HUF_DECBITS
    sym_t = np.full(size, -1, np.int64)
    len_t = np.zeros(size, np.int64)
    long_codes = {}  # prefix (14 bits) -> list[(l, code, sym)]
    for sym in np.nonzero(used)[0]:
        l = int(lengths[sym])
        code = int(codes[sym])
        if l <= HUF_DECBITS:
            base = code << (HUF_DECBITS - l)
            span = 1 << (HUF_DECBITS - l)
            sym_t[base:base + span] = sym
            len_t[base:base + span] = l
        else:
            prefix = code >> (l - HUF_DECBITS)
            long_codes.setdefault(prefix, []).append((l, code, int(sym)))
    for v in long_codes.values():
        v.sort()

    rlc = iM
    out = np.zeros(n_out, np.uint32)
    oi = 0
    c = 0
    lc = 0
    pos = 0
    buf = data + b"\x00" * 16
    nbuf = len(data)
    mask64 = (1 << 64) - 1
    while oi < n_out:
        while lc < HUF_DECBITS + 16:
            c = ((c << 8) | buf[pos]) & mask64
            pos += 1
            lc += 8
        idx = (c >> (lc - HUF_DECBITS)) & (size - 1)
        l = int(len_t[idx])
        if l > 0:
            sym = int(sym_t[idx])
            lc -= l
        else:
            cand = long_codes.get(int(idx))
            sym = -1
            if cand:
                for (cl, ccode, csym) in cand:
                    if lc >= cl and ((c >> (lc - cl))
                                     & ((1 << cl) - 1)) == ccode:
                        sym = csym
                        lc -= cl
                        break
            if sym < 0:
                break  # padding / corrupt stream
        if sym == rlc:
            if lc < 8:
                c = ((c << 8) | buf[pos]) & mask64
                pos += 1
                lc += 8
            run = (c >> (lc - 8)) & 0xFF
            lc -= 8
            out[oi:oi + run] = out[oi - 1]
            oi += run
        else:
            out[oi] = sym
            oi += 1
    return out.astype(np.uint16)


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, _table_len, nbits, _room = struct.unpack_from("<5I", data, 0)
    reader = _BitReader(data[20:])
    lengths = _unpack_enc_table(reader, im, iM)
    codes = _canonical_codes(lengths)
    bitstream = data[20 + reader.pos:]
    return _huf_decode_fast(bitstream, im, iM, nbits, lengths, codes, n_out)


# ---------------------------------------------------------------------------
# 2D wavelet decode (ImfWav.cpp wav2Decode)
# ---------------------------------------------------------------------------

def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hs = h.astype(np.int16).astype(np.int64)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai
    b = ai - hs
    return (a & 0xFFFF).astype(np.uint16), (b & 0xFFFF).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def wav2_decode(a: np.ndarray, nx: int, ny: int, mx: int):
    """In-place 2D wavelet decode of an (ny, nx) uint16 array."""
    w14 = mx < (1 << 14)
    dec = _wdec14 if w14 else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    while p >= 1:
        # iterate 2x2 blocks with stride p2, offsets p
        ey = ((ny - 1) // p2) * p2
        ex = ((nx - 1) // p2) * p2
        ys = np.arange(0, ey + 1, p2)
        xs = np.arange(0, ex + 1, p2)
        has_y1 = ys + p <= ny - 1
        has_x1 = xs + p <= nx - 1

        Y0, X0 = np.meshgrid(ys, xs, indexing="ij")
        # full 2x2 blocks
        by = has_y1[:, None] & np.ones_like(has_x1)[None, :]
        bx = np.ones_like(has_y1)[:, None] & has_x1[None, :]
        full = by & bx
        y0f, x0f = Y0[full], X0[full]
        if len(y0f):
            i00 = a[y0f, x0f]
            i01 = a[y0f, x0f + p]
            i10 = a[y0f + p, x0f]
            i11 = a[y0f + p, x0f + p]
            t00, t10 = dec(i00, i10)
            t01, t11 = dec(i01, i11)
            o00, o01 = dec(t00, t01)
            o10, o11 = dec(t10, t11)
            a[y0f, x0f] = o00
            a[y0f, x0f + p] = o01
            a[y0f + p, x0f] = o10
            a[y0f + p, x0f + p] = o11
        # row-only blocks (no x+p): vertical pair decode
        rowonly = by & ~bx
        y0r, x0r = Y0[rowonly], X0[rowonly]
        if len(y0r):
            i00 = a[y0r, x0r]
            i10 = a[y0r + p, x0r]
            o00, o10 = dec(i00, i10)
            a[y0r, x0r] = o00
            a[y0r + p, x0r] = o10
        # col-only blocks (no y+p): horizontal pair decode
        colonly = ~by & bx
        y0c, x0c = Y0[colonly], X0[colonly]
        if len(y0c):
            i00 = a[y0c, x0c]
            i01 = a[y0c, x0c + p]
            o00, o01 = dec(i00, i01)
            a[y0c, x0c] = o00
            a[y0c, x0c + p] = o01
        p2 = p
        p >>= 1
    return a


# ---------------------------------------------------------------------------
# chunk decode
# ---------------------------------------------------------------------------

def piz_uncompress(chunk: bytes, channels, width: int, nlines: int):
    """Decode one PIZ scanline block.

    channels: list of (name, numpy dtype) in file order.  Returns raw
    bytes in the standard scanline-interleaved layout (per line, per
    channel) so read_exr's existing unpacking applies.
    """
    min_nz, max_nz = struct.unpack_from("<2H", chunk, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(
            chunk, np.uint8, count, pos)
        pos += count
    (comp_len,) = struct.unpack_from("<i", chunk, pos)
    pos += 4

    # forward LUT: value -> compact index; reverse: index -> value
    bits = np.unpackbits(bitmap, bitorder="little")
    present = np.nonzero(bits)[0]
    # value 0 is always representable even if not in the bitmap
    reverse_lut = present.astype(np.uint16)
    if len(reverse_lut) == 0 or reverse_lut[0] != 0:
        reverse_lut = np.concatenate(
            [[0], present]).astype(np.uint16)
    max_value = len(reverse_lut) - 1

    # total u16 count: channels assumed full-sampled
    n_half = sum(
        (dt.itemsize // 2) * width * nlines for _, dt in channels
    )
    data = huf_uncompress(chunk[pos:pos + comp_len], n_half)

    # per-channel planar wavelet decode.  A channel with itemsize > 2
    # (FLOAT/UINT) holds `sz` u16 words per pixel, interleaved within
    # the line; each word plane is decoded SEPARATELY with horizontal
    # stride sz (ImfPizCompressor calls wav2Decode per j in [0, size)).
    out_planes = []
    off = 0
    for name, dt in channels:
        sz = dt.itemsize // 2  # u16 words per sample
        plane = data[off:off + sz * width * nlines].copy()
        off += sz * width * nlines
        plane3 = plane.reshape(nlines, width, sz)
        for j in range(sz):
            wav2_decode(plane3[:, :, j], width, nlines, max_value)
        plane = reverse_lut[np.minimum(plane3.reshape(nlines, width * sz),
                                       max_value)]
        out_planes.append(plane)

    # interleave to scanline layout
    raw = bytearray()
    for ln in range(nlines):
        for (name, dt), plane in zip(channels, out_planes):
            raw += plane[ln].astype("<u2").tobytes()
    return bytes(raw)


# ---------------------------------------------------------------------------
# Encode side (mirror of the above; ImfPizCompressor::compress semantics)
# ---------------------------------------------------------------------------

def _wenc14(a, b):
    av = a.astype(np.int16).astype(np.int64)
    bv = b.astype(np.int16).astype(np.int64)
    m = (av + bv) >> 1
    d = av - bv
    return (m & 0xFFFF).astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int64) + A_OFFSET) & MOD_MASK
    bv = b.astype(np.int64)
    m = (ao + bv) >> 1
    d = ao - bv
    m = np.where(d < 0, (m + A_OFFSET) & MOD_MASK, m)
    d &= MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def wav2_encode(a: np.ndarray, nx: int, ny: int, mx: int):
    """In-place 2D wavelet encode of an (ny, nx) uint16 array (the
    exact mirror of wav2_decode: horizontal pairs first, then
    vertical, fine-to-coarse)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ey = ((ny - 1) // p2) * p2
        ex = ((nx - 1) // p2) * p2
        ys = np.arange(0, ey + 1, p2)
        xs = np.arange(0, ex + 1, p2)
        has_y1 = ys + p <= ny - 1
        has_x1 = xs + p <= nx - 1

        Y0, X0 = np.meshgrid(ys, xs, indexing="ij")
        by = has_y1[:, None] & np.ones_like(has_x1)[None, :]
        bx = np.ones_like(has_y1)[:, None] & has_x1[None, :]
        full = by & bx
        y0f, x0f = Y0[full], X0[full]
        if len(y0f):
            a00 = a[y0f, x0f]
            a01 = a[y0f, x0f + p]
            a10 = a[y0f + p, x0f]
            a11 = a[y0f + p, x0f + p]
            i00, i01 = enc(a00, a01)
            i10, i11 = enc(a10, a11)
            o00, o10 = enc(i00, i10)
            o01, o11 = enc(i01, i11)
            a[y0f, x0f] = o00
            a[y0f, x0f + p] = o01
            a[y0f + p, x0f] = o10
            a[y0f + p, x0f + p] = o11
        rowonly = by & ~bx
        y0r, x0r = Y0[rowonly], X0[rowonly]
        if len(y0r):
            o00, o10 = enc(a[y0r, x0r], a[y0r + p, x0r])
            a[y0r, x0r] = o00
            a[y0r + p, x0r] = o10
        colonly = ~by & bx
        y0c, x0c = Y0[colonly], X0[colonly]
        if len(y0c):
            o00, o01 = enc(a[y0c, x0c], a[y0c, x0c + p])
            a[y0c, x0c] = o00
            a[y0c, x0c + p] = o01
        p = p2
        p2 <<= 1
    return a


class _BitWriter:
    __slots__ = ("chunks", "c", "lc", "nbits")

    def __init__(self):
        self.chunks = bytearray()
        self.c = 0
        self.lc = 0
        self.nbits = 0

    def put_bits(self, n: int, val: int):
        self.c = (self.c << n) | (val & ((1 << n) - 1))
        self.lc += n
        self.nbits += n
        while self.lc >= 8:
            self.lc -= 8
            self.chunks.append((self.c >> self.lc) & 0xFF)
            self.c &= (1 << self.lc) - 1

    def bytes(self) -> bytes:
        out = bytearray(self.chunks)
        if self.lc:
            out.append((self.c << (8 - self.lc)) & 0xFF)
        return bytes(out)


def _huf_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Standard Huffman code lengths (the decoder accepts any canonical
    table with lengths <= 58; OpenEXR's own builder differs only in
    tie-breaking)."""
    import heapq

    syms = np.nonzero(freq)[0]
    lengths = np.zeros(freq.shape[0], np.int64)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    # internal tree with parent links; depth of each leaf = code length
    parent = {}
    heap = [(int(freq[s]), int(s)) for s in syms]
    heapq.heapify(heap)
    next_id = USHORT_RANGE + 1
    while len(heap) > 1:
        fa, a = heapq.heappop(heap)
        fb, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        heapq.heappush(heap, (fa + fb, next_id))
        next_id += 1
    depth = {heap[0][1]: 0}
    for node in range(next_id - 1, USHORT_RANGE, -1):
        if node in parent:
            depth[node] = depth[parent[node]] + 1
    for s in syms:
        lengths[s] = depth[parent[int(s)]] + 1 if int(s) in parent else 0
    if lengths.max() > 58:
        raise ValueError("huffman code length > 58")
    return lengths


def _pack_enc_table(writer: _BitWriter, lengths: np.ndarray,
                    im: int, iM: int):
    """Mirror of _unpack_enc_table (6-bit lengths, zero-run escapes)."""
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            run = 1
            while i + run <= iM and lengths[i + run] == 0 \
                    and run < 255 + SHORTEST_LONG_RUN:
                run += 1
            if run >= SHORTEST_LONG_RUN:
                writer.put_bits(6, LONG_ZEROCODE_RUN)
                writer.put_bits(8, run - SHORTEST_LONG_RUN)
                i += run
                continue
            if run >= 2:
                writer.put_bits(6, SHORT_ZEROCODE_RUN + run - 2)
                i += run
                continue
        writer.put_bits(6, l)
        i += 1


def huf_compress(data: np.ndarray) -> bytes:
    """Huffman-compress uint16 symbols (ImfHuf hufCompress layout)."""
    data = np.asarray(data, np.uint16)
    if data.size == 0:
        return b""
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    data_max = int(np.nonzero(freq)[0].max())
    rlc = data_max + 1          # run-length escape symbol == iM
    freq[rlc] = 1
    im = int(np.nonzero(freq)[0].min())
    iM = rlc
    lengths = _huf_code_lengths(freq)
    codes = _canonical_codes(lengths)

    tw = _BitWriter()
    _pack_enc_table(tw, lengths, im, iM)
    table_bytes = tw.bytes()

    # split data into runs of equal symbols
    bw = _BitWriter()
    change = np.nonzero(np.diff(data))[0] + 1
    starts = np.concatenate([[0], change])
    run_lens = np.diff(np.concatenate([starts, [data.size]]))
    sym_l = lengths[data[starts]]
    rlc_l = int(lengths[rlc])
    rlc_c = int(codes[rlc])
    for s, r, sl in zip(data[starts].tolist(), run_lens.tolist(),
                        sym_l.tolist()):
        c = int(codes[s])
        # first occurrence always literal; remainder as 8-bit runs when
        # cheaper (sendCode semantics)
        bw.put_bits(sl, c)
        rest = r - 1
        if rest and (rlc_l + 8 < sl * rest):
            while rest > 0:
                n = min(rest, 255)
                bw.put_bits(rlc_l, rlc_c)
                bw.put_bits(8, n)
                rest -= n
        else:
            for _ in range(rest):
                bw.put_bits(sl, c)
    bits = bw.bytes()
    header = struct.pack("<5I", im, iM, len(table_bytes), bw.nbits, 0)
    return header + table_bytes + bits


def piz_compress(raw: bytes, channels, width: int, nlines: int) -> bytes:
    """Encode one PIZ scanline block from scanline-interleaved raw
    bytes (per line, per channel).  Mirror of piz_uncompress."""
    # deinterleave into per-channel (nlines, width*sz) u16 planes
    planes = []
    rpos = 0
    for name, dt in channels:
        planes.append(np.zeros((nlines, width * (dt.itemsize // 2)),
                               np.uint16))
    for ln in range(nlines):
        for ci, (name, dt) in enumerate(channels):
            n = width * dt.itemsize
            planes[ci][ln] = np.frombuffer(
                raw, dtype="<u2", count=width * (dt.itemsize // 2),
                offset=rpos)
            rpos += n

    # bitmap of present values (zero is implicit), forward LUT
    allv = np.concatenate([p.ravel() for p in planes])
    present = np.zeros(USHORT_RANGE, bool)
    present[allv] = True
    present[0] = False
    bitmap = np.packbits(present.view(np.uint8), bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0   # min > max: empty
    lut = np.zeros(USHORT_RANGE, np.uint16)
    vals = np.concatenate([[0], np.nonzero(present)[0]]) \
        if not present[0] else np.nonzero(present)[0]
    lut[vals] = np.arange(len(vals), dtype=np.uint16)
    max_value = len(vals) - 1

    pieces = []
    for (name, dt), plane in zip(channels, planes):
        sz = dt.itemsize // 2
        p = lut[plane].reshape(nlines, width, sz)
        for j in range(sz):
            wav2_encode(p[:, :, j], width, nlines, max_value)
        pieces.append(p.reshape(-1))
    data = np.concatenate(pieces)
    huf = huf_compress(data)

    out = struct.pack("<2H", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz:max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf)) + huf
    return out
