"""OpenEXR decoding in numpy and zlib, as cv2 4.13 reads it through
OpenEXR 2.3 (``grfmt_exr.cpp`` over ``Imf::InputFile``).

The reference reads depth with ``cv2.imread(path, IMREAD_UNCHANGED)``
and colour with ``cv2.imread(path)`` (``diffdope_tpu/image.py:59``,
``image.py:64``), textures through ``cv2.imread`` (``mesh.py:1033``) and
glTF images through ``cv2.imdecode`` (``mesh.py:435``).  The files:

- the header: version 2 only, the flags OpenEXR 2.3 knows (tiled, long
  names, deep, multi-part); scanline and single-part tiled files, of
  which the level-0 tiles of one-level, mip- and rip-mapped files; the
  data window (the display window is ignored); every line order;
- the compressions: none, RLE, ZIPS, ZIP (zlib, the byte predictor and
  the two-half interleave), PXR24, PIZ (the range bitmap, the Haar
  wavelet, OpenEXR's Huffman code), B44 and B44A (4x4 blocks of half
  samples), DWAA and DWAB (version 2: the channel rules; lossy DCT with
  the SSE2 inverse DCT's arithmetic, Rec. 709 Y'CbCr for R/G/B sets and
  ``toLinear``; RLE; zlib); a block its coding does not shrink is stored
  raw;
- HALF, FLOAT and UINT samples, all read as float32 (``(float) u`` for
  UINT), as cv2 asks OpenEXR for FLOAT.

What cv2 then does with the channels is :func:`_to_cv2`'s docstring.
cv2 gates the codec behind the environment variable
``OPENCV_IO_ENABLE_OPENEXR``: unset or false, every read raises (cv2
raises ``cv2.error``; here :class:`CodecDisabled`, a ``ValueError``), and
a value it cannot parse raises too (:func:`enabled`).

Files cv2 reads no image from give None: truncated ones, version 1 or
unknown flags, multi-part files of more than one part (a one-part file is
read), channels cv2 does not take, and the DWAA and DWAB files cv2 4.13
writes (a header and an offset table of zeros: its OpenEXR writes no
DWA data).  A file whose offset table has an entry <= 0 is repaired as
OpenEXR repairs it, by walking the chunks.  Deep data (cv2 reads a deep
scanline file's composite), DWA blocks of version 0 or 1 (the legacy
rules) and B44 on channels stored perceptually linear raise
``ValueError`` naming the variant and the file: cv2 reads them, the port
does not.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"v/1\x01"
#: cv2's switch for its OpenEXR codec (``OPENCV_IO_ENABLE_OPENEXR``)
GATE = "OPENCV_IO_ENABLE_OPENEXR"
#: the values cv2's ``getConfigurationParameterBool`` parses
_TRUE, _FALSE = ("1", "True", "true", "TRUE"), ("0", "False", "false", "FALSE")
_COMPRESSIONS = ("none", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB")
_BLOCK_LINES = (1, 1, 1, 16, 32, 16, 32, 32, 32, 256)
_UINT, _HALF, _FLOAT = 0, 1, 2
_SIZES = {_UINT: 4, _HALF: 2, _FLOAT: 4}
_KNOWN_FLAGS = 0x200 | 0x400 | 0x800 | 0x1000


class CodecDisabled(ValueError):
    """cv2's OpenEXR codec is off (``OPENCV_IO_ENABLE_OPENEXR`` unset or
    false): cv2 raises on every read."""


class _NoImage(Exception):
    """A file OpenEXR or cv2 fails on: cv2 gives None."""


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def matches(data: bytes) -> bool:
    return data.startswith(SIGNATURE)


def enabled() -> bool:
    """cv2's gate: True for 1/true/True/TRUE, False unset or for
    0/false/False/FALSE; :class:`CodecDisabled` for any other value, on
    which cv2 4.13 raises too ("Invalid value for parameter")."""
    value = os.environ.get(GATE)
    if value is None or value in _FALSE:
        return False
    if value in _TRUE:
        return True
    raise CodecDisabled(f"invalid value for parameter {GATE}: {value!r} (format: OpenEXR): "
                        "cv2 raises on it, and the port does the same")


def _check_gate(source: Optional[str]) -> None:
    if not enabled():
        raise CodecDisabled(
            f"{_where(source)}: cv2's OpenEXR codec is disabled (format: OpenEXR): cv2 "
            f"raises unless {GATE} is set to 1 or true, and the port does the same")


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

def _cstring(data: bytes, at: int, limit: int) -> Tuple[str, int]:
    end = data.find(b"\0", at, at + limit + 1)
    if end < 0:
        raise _NoImage("attribute name too long or unterminated")
    return data[at:end].decode("latin-1"), end + 1


def _attributes(data: bytes, at: int, limit: int) -> Tuple[Dict[str, Tuple[str, bytes]], int]:
    """One header: name -> (type, value bytes), and the offset past it."""
    attrs = {}
    while True:
        if at >= len(data):
            raise _NoImage("header runs past the file")
        if data[at] == 0:
            return attrs, at + 1
        name, at = _cstring(data, at, limit)
        kind, at = _cstring(data, at, limit)
        if at + 4 > len(data):
            raise _NoImage("header runs past the file")
        (size,) = struct.unpack_from("<i", data, at)
        at += 4
        if size < 0 or at + size > len(data):
            raise _NoImage("attribute runs past the file")
        attrs[name] = (kind, data[at:at + size])
        at += size


def _channels(value: bytes, limit: int) -> List[Dict]:
    out, at = [], 0
    while at < len(value) and value[at] != 0:
        name, at = _cstring(value, at, limit)
        kind, linear, xs, ys = struct.unpack_from("<iB3xii", value, at)
        at += 16
        if kind not in _SIZES or xs < 1 or ys < 1:
            raise _NoImage("bad channel")
        out.append(dict(name=name, type=kind, linear=bool(linear), xs=xs, ys=ys))
    return sorted(out, key=lambda c: c["name"].encode("latin-1"))


def _part(attrs, tiled: bool, limit: int) -> Dict:
    def need(name, kind):
        if name not in attrs or attrs[name][0] != kind:
            raise _NoImage(f"no {name} attribute")
        return attrs[name][1]

    x0, y0, x1, y1 = struct.unpack("<iiii", need("dataWindow", "box2i")[:16])
    comp = need("compression", "compression")[0]
    order = need("lineOrder", "lineOrder")[0]
    need("displayWindow", "box2i")
    if comp >= len(_COMPRESSIONS) or order > 2 or x1 < x0 or y1 < y0:
        raise _NoImage("bad compression, line order or data window")
    chans = _channels(need("channels", "chlist"), limit)
    for c in chans:
        if x0 % c["xs"] or y0 % c["ys"] or (x1 - x0 + 1) % c["xs"] or (y1 - y0 + 1) % c["ys"]:
            raise _NoImage("data window not a multiple of a channel's sampling")
    part = dict(x0=x0, y0=y0, w=x1 - x0 + 1, h=y1 - y0 + 1, compression=comp, order=order,
                channels=chans, tile=None, kind=None, chroma=None)
    if "type" in attrs:
        part["kind"] = attrs["type"][1].decode("latin-1")
    if tiled or part["kind"] == "tiledimage":
        tx, ty, mode = struct.unpack("<IIB", need("tiles", "tiledesc")[:9])
        if tx < 1 or ty < 1 or (mode & 15) > 2 or (mode >> 4) > 1:
            raise _NoImage("bad tile description")
        part["tile"] = (tx, ty, mode & 15, mode >> 4)
        if any(c["xs"] != 1 or c["ys"] != 1 for c in chans):
            raise _NoImage("subsampled channels in a tiled file")
    if "chromaticities" in attrs and attrs["chromaticities"][0] == "chromaticities":
        part["chroma"] = struct.unpack("<8f", attrs["chromaticities"][1][:32])
    return part


def _level_tiles(part) -> int:
    """The number of level-0 tiles (the offset table holds them first)."""
    tx, ty = part["tile"][:2]
    return -(-part["w"] // tx) * -(-part["h"] // ty)


def _table_length(part) -> int:
    if part["tile"] is None:
        return -(-part["h"] // _BLOCK_LINES[part["compression"]])
    w, h = part["w"], part["h"]
    tx, ty, mode, rounding = part["tile"]

    def log2(n):
        k = 0
        while (1 << (k + 1)) <= n:
            k += 1
        return k + (rounding == 1 and (1 << k) < n)

    def size(n, lv):
        return max(((n + (1 << lv) - 1) if rounding else n) >> lv, 1)

    if mode == 0:
        levels = [(w, h)]
    elif mode == 1:
        levels = [(size(w, lv), size(h, lv)) for lv in range(log2(max(w, h)) + 1)]
    else:
        levels = [(size(w, lx), size(h, ly)) for ly in range(log2(h) + 1)
                  for lx in range(log2(w) + 1)]
    return sum(-(-lw // tx) * -(-lh // ty) for lw, lh in levels)


# ---------------------------------------------------------------------------
# the lossless codings
# ---------------------------------------------------------------------------

def _unpredict(t: np.ndarray) -> bytes:
    """Undo ZIP's and RLE's byte predictor and two-half interleave."""
    d = t.astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 255).astype(np.uint8)
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _rle(data: bytes, size: int) -> np.ndarray:
    out = bytearray()
    at = 0
    while at < len(data) and len(out) < size:
        count = data[at] - 256 if data[at] > 127 else data[at]
        if count < 0:
            out += data[at + 1:at + 1 - count]
            at += 1 - count
        else:
            if at + 1 >= len(data):
                raise _NoImage("RLE data end early")
            out += data[at + 1:at + 2] * (count + 1)
            at += 2
    if len(out) != size:
        raise _NoImage("RLE data of the wrong size")
    return np.frombuffer(bytes(out), np.uint8)


def _zlib(data: bytes, size: int) -> bytes:
    try:
        raw = zlib.decompress(data)
    except zlib.error as err:
        raise _NoImage(f"zlib: {err}") from None
    if len(raw) != size:
        raise _NoImage("zlib data of the wrong size")
    return raw


def _num_samples(s: int, a: int, b: int) -> int:
    a1, b1 = a // s, b // s
    return b1 - a1 + (0 if a1 * s < a else 1)


def _geometry(chans, x0, x1, y0, y1):
    """Per channel (nx, ny, type) of a block spanning x0..x1, y0..y1."""
    return [(_num_samples(c["xs"], x0, x1), _num_samples(c["ys"], y0, y1), c["type"])
            for c in chans]


def _pxr24(raw: bytes, geometry, lines) -> List[np.ndarray]:
    """PXR24's planes (per line, per channel: the differences' bytes,
    high first) back to per channel (ny, nx) uint32 / uint16 samples, a
    float's 24 bits moved up by 8."""
    buf = np.frombuffer(raw, np.uint8)
    at = 0
    out = [[] for _ in geometry]
    for _, present in lines:
        for i, nx in present:
            kind = geometry[i][2]
            planes = {_UINT: 4, _HALF: 2, _FLOAT: 3}[kind]
            seg = buf[at:at + planes * nx].reshape(planes, nx).astype(np.uint32)
            at += planes * nx
            if kind == _UINT:
                diff = (seg[0] << 24) | (seg[1] << 16) | (seg[2] << 8) | seg[3]
            elif kind == _HALF:
                diff = (seg[0] << 8) | seg[1]
            else:
                diff = (seg[0] << 24) | (seg[1] << 16) | (seg[2] << 8)
            px = np.cumsum(diff, dtype=np.uint32)
            out[i].append(px.astype(np.uint16) if kind == _HALF else px)
    if at != len(buf):
        raise _NoImage("PXR24 data of the wrong size")
    return [np.stack(rows) if rows else np.zeros((0, g[0]), np.uint32)
            for rows, g in zip(out, geometry)]


# ---------------------------------------------------------------------------
# PIZ: OpenEXR's Huffman code, the Haar wavelet, the range bitmap
# ---------------------------------------------------------------------------

_HUF_ENCSIZE = (1 << 16) + 1
_SHORT_ZEROCODE_RUN, _LONG_ZEROCODE_RUN = 59, 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN


def _huf_table(data: bytes, at: int, end: int, im: int, iM: int):
    """``hufUnpackEncTable`` and ``hufCanonicalCodeTable``: the code
    lengths of symbols im..iM (six bits each, zero runs folded) and the
    canonical codes -> (lengths (65537,), codes (65537,)), offset past the
    table."""
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    c, lc, p = 0, 0, at

    def bits(n):
        nonlocal c, lc, p
        while lc < n:
            if p >= end:
                raise _NoImage("Huffman table runs past its data")
            c = ((c << 8) | data[p]) & 0xFFFFFFFFFFFF
            p += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    i = im
    while i <= iM:
        ln = bits(6)
        if ln == _LONG_ZEROCODE_RUN:
            run = bits(8) + _SHORTEST_LONG_RUN
            if i + run > iM + 1:
                raise _NoImage("Huffman table too long")
            i += run
        elif ln >= _SHORT_ZEROCODE_RUN:
            run = ln - _SHORT_ZEROCODE_RUN + 2
            if i + run > iM + 1:
                raise _NoImage("Huffman table too long")
            i += run
        else:
            lengths[i] = ln
            i += 1
    n = np.bincount(lengths, minlength=59)[:59]
    start = np.zeros(59, np.int64)
    code = 0
    for ln in range(58, 0, -1):
        start[ln] = code
        code = (code + n[ln]) >> 1
    codes = np.zeros(_HUF_ENCSIZE, np.int64)
    order = np.argsort(lengths, kind="stable")
    order = order[lengths[order] > 0]
    lens = lengths[order]
    rank = np.arange(len(order)) - np.searchsorted(lens, lens)
    codes[order] = start[lens] + rank
    return lengths, codes, p


def _huf_decode(data: bytes, at: int, length: int, count: int) -> np.ndarray:
    """``hufUncompress``: ``count`` unsigned shorts from the ``length``
    bytes at ``at``; the largest symbol is the run code (the next 8 bits
    repeat the last symbol that many times).

    One Python step a code: the 64 bits from each byte are precomputed,
    a 14-bit table gives the codes of up to 14 bits (as OpenEXR's), and a
    longer code is found by its length, the canonical codes of a length
    being consecutive in symbol order."""
    if length == 0:
        if count:
            raise _NoImage("PIZ: no Huffman data")
        return np.zeros(0, np.uint16)
    if length < 20:
        raise _NoImage("PIZ: Huffman header runs past its data")
    im, iM, _, nbits = struct.unpack_from("<IIII", data, at)
    end = at + length
    if im >= _HUF_ENCSIZE or iM >= _HUF_ENCSIZE or im > iM:
        raise _NoImage("PIZ: bad Huffman table size")
    lengths, codes, p = _huf_table(data, at + 20, end, im, iM)
    if nbits > 8 * (end - p):
        raise _NoImage("PIZ: Huffman bit count past its data")
    syms = np.nonzero(lengths)[0]
    if not len(syms):
        raise _NoImage("PIZ: empty Huffman table")
    fast = np.full(1 << 14, -1, np.int64)
    longs = []  # (length, first code, symbols in code order)
    for ln in np.unique(lengths[syms]).tolist():
        of = syms[lengths[syms] == ln]
        of = of[np.argsort(codes[of], kind="stable")]
        if ln <= 14:
            for s_, c_ in zip(of.tolist(), codes[of].tolist()):
                base = c_ << (14 - ln)
                fast[base:base + (1 << (14 - ln))] = s_ << 6 | ln
        else:
            longs.append((ln, int(codes[of[0]]), of.tolist()))
    fast = fast.tolist()
    b = np.frombuffer(data[p:end] + bytes(9), np.uint8).astype(np.uint64)
    n = end - p
    word = b[:n].copy() << np.uint64(56)
    for k in range(1, 8):
        word |= b[k:n + k] << np.uint64(56 - 8 * k)
    words = word.tolist()
    out_e, reps = [], []
    pos, rlc = 0, iM
    while pos < nbits:
        w = words[pos >> 3]
        sh = pos & 7
        e = fast[(w >> (50 - sh)) & 0x3FFF]
        if e >= 0:
            pos += e & 63
            s_ = e >> 6
        else:
            big = int.from_bytes(data[p + (pos >> 3):p + (pos >> 3) + 9].ljust(9, b"\0"), "big")
            for ln, first, of in longs:
                v = ((big >> (72 - ln - sh)) & ((1 << ln) - 1)) - first
                if 0 <= v < len(of):
                    s_ = of[v]
                    e = s_ << 6 | ln
                    pos += ln
                    break
            else:
                raise _NoImage("PIZ: invalid Huffman code")
        if pos > nbits:
            raise _NoImage("PIZ: Huffman code past its data")
        if s_ == rlc:
            if pos + 8 > nbits or not reps:
                raise _NoImage("PIZ: bad run")
            reps[-1] += (words[pos >> 3] >> (56 - (pos & 7))) & 255
            pos += 8
        else:
            out_e.append(e)
            reps.append(1)
    out = np.repeat(np.asarray(out_e, np.int64) >> 6, reps)
    if len(out) != count:
        raise _NoImage("PIZ: Huffman data of the wrong length")
    return out.astype(np.uint16)


def _wdec(lo, hi, w14: bool):
    """``wdec14`` / ``wdec16`` on int64 arrays of unsigned shorts."""
    if w14:
        ls = np.where(lo >= 0x8000, lo - 0x10000, lo)
        hs = np.where(hi >= 0x8000, hi - 0x10000, hi)
        ai = ls + (hs & 1) + (hs >> 1)
        return ai & 0xFFFF, (ai - hs) & 0xFFFF
    b = (lo - (hi >> 1)) & 0xFFFF
    return (hi + b - 0x8000) & 0xFFFF, b


def _wav2_decode(a: np.ndarray, mx: int) -> None:
    """``wav2Decode`` in place on an (ny, nx) int64 plane."""
    ny, nx = a.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            yy, xx = np.ix_(ys, xs)
            i00, i10 = _wdec(a[yy, xx], a[yy + p, xx], w14)
            i01, i11 = _wdec(a[yy, xx + p], a[yy + p, xx + p], w14)
            a[yy, xx], a[yy, xx + p] = _wdec(i00, i01, w14)
            a[yy + p, xx], a[yy + p, xx + p] = _wdec(i10, i11, w14)
        if nx & p and len(ys):  # the odd column
            x = (len(xs)) * p2
            a[ys, x], a[ys + p, x] = _wdec(a[ys, x], a[ys + p, x], w14)
        if ny & p:  # the odd line
            y = len(ys) * p2
            a[y, xs], a[y, xs + p] = _wdec(a[y, xs], a[y, xs + p], w14)
        p2 = p
        p >>= 1


def _piz(data: bytes, geometry) -> List[np.ndarray]:
    """PIZ's block -> per channel (ny, nx * size) uint16 (a FLOAT or UINT
    sample two shorts, low first)."""
    if len(data) < 4:
        raise _NoImage("PIZ block too short")
    lo, hi = struct.unpack_from("<HH", data, 0)
    at = 4
    bitmap = np.zeros(8192, np.uint8)
    if hi >= 8192:
        raise _NoImage("PIZ: bad bitmap range")
    if lo <= hi:
        if at + hi - lo + 1 > len(data):
            raise _NoImage("PIZ: bitmap past the block")
        bitmap[lo:hi + 1] = np.frombuffer(data, np.uint8, hi - lo + 1, at)
        at += hi - lo + 1
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.nonzero(present)[0]
    mx = len(lut) - 1
    if at + 4 > len(data):
        raise _NoImage("PIZ: no Huffman length")
    (length,) = struct.unpack_from("<i", data, at)
    at += 4
    if length < 0 or at + length > len(data):
        raise _NoImage("PIZ: Huffman data past the block")
    sizes = [(nx, ny, _SIZES[kind] // 2) for nx, ny, kind in geometry]
    total = sum(nx * ny * s for nx, ny, s in sizes)
    flat = _huf_decode(data, at, length, total).astype(np.int64)
    out, start = [], 0
    for nx, ny, s in sizes:
        plane = flat[start:start + nx * ny * s].reshape(ny, nx, s)
        start += nx * ny * s
        for j in range(s):
            sub = np.ascontiguousarray(plane[..., j])
            if sub.size:
                _wav2_decode(sub, mx)
            plane[..., j] = sub
        full = np.zeros(65536, np.int64)
        full[:len(lut)] = lut
        out.append(full[plane.reshape(ny, nx * s)].astype(np.uint16))
    return out


# ---------------------------------------------------------------------------
# B44 / B44A
# ---------------------------------------------------------------------------

def _b44_blocks(b: np.ndarray) -> np.ndarray:
    """``unpack14`` on (n, 14) uint8 -> (n, 16) uint16."""
    b = b.astype(np.int64)
    s = np.zeros((len(b), 16), np.int64)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    shift = b[:, 2] >> 2
    bias = 0x20 << shift

    def d(v):
        return ((v & 0x3F) << shift) - bias

    s[:, 4] = s[:, 0] + d((b[:, 2] << 4) | (b[:, 3] >> 4))
    s[:, 8] = s[:, 4] + d((b[:, 3] << 2) | (b[:, 4] >> 6))
    s[:, 12] = s[:, 8] + d(b[:, 4])
    s[:, 1] = s[:, 0] + ((b[:, 5] >> 2) << shift) - bias
    s[:, 5] = s[:, 4] + d((b[:, 5] << 4) | (b[:, 6] >> 4))
    s[:, 9] = s[:, 8] + d((b[:, 6] << 2) | (b[:, 7] >> 6))
    s[:, 13] = s[:, 12] + d(b[:, 7])
    s[:, 2] = s[:, 1] + ((b[:, 8] >> 2) << shift) - bias
    s[:, 6] = s[:, 5] + d((b[:, 8] << 4) | (b[:, 9] >> 4))
    s[:, 10] = s[:, 9] + d((b[:, 9] << 2) | (b[:, 10] >> 6))
    s[:, 14] = s[:, 13] + d(b[:, 10])
    s[:, 3] = s[:, 2] + ((b[:, 11] >> 2) << shift) - bias
    s[:, 7] = s[:, 6] + d((b[:, 11] << 4) | (b[:, 12] >> 4))
    s[:, 11] = s[:, 10] + d((b[:, 12] << 2) | (b[:, 13] >> 6))
    s[:, 15] = s[:, 14] + d(b[:, 13])
    return s & 0xFFFF


def _b44_unorder(s: np.ndarray) -> np.ndarray:
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF)


def _b44(data: bytes, geometry, chans, where: str) -> List[np.ndarray]:
    """B44's block -> per channel (ny, nx * size) uint16."""
    buf = np.frombuffer(data, np.uint8)
    at, out = 0, []
    for (nx, ny, kind), c in zip(geometry, chans):
        if kind != _HALF:
            n = nx * ny * 2 * (_SIZES[kind] // 2)
            if at + n > len(buf):
                raise _NoImage("B44 data end early")
            out.append(buf[at:at + n].view("<u2").reshape(ny, -1).astype(np.uint16))
            at += n
            continue
        if c["linear"]:
            raise ValueError(f"{where}: OpenEXR B44 on the perceptually linear channel "
                             f"{c['name']!r} (format: OpenEXR): the port does not read it")
        bx, by = -(-nx // 4), -(-ny // 4)
        starts, flat = [], []
        for _ in range(bx * by):
            if at + 3 > len(buf):
                raise _NoImage("B44 data end early")
            starts.append(at)
            is_flat = buf[at + 2] == 0xFC
            flat.append(is_flat)
            at += 3 if is_flat else 14
            if at > len(buf):
                raise _NoImage("B44 data end early")
        starts, flat = np.asarray(starts, np.int64), np.asarray(flat, bool)
        blocks = np.zeros((bx * by, 16), np.int64)
        if (~flat).any():
            idx = starts[~flat][:, None] + np.arange(14)
            blocks[~flat] = _b44_blocks(buf[idx])
        if flat.any():
            first = (buf[starts[flat]].astype(np.int64) << 8) | buf[starts[flat] + 1]
            blocks[flat] = first[:, None]
        blocks = _b44_unorder(blocks)
        grid = blocks.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(by * 4, bx * 4)
        out.append(grid[:ny, :nx].astype(np.uint16))
    return out


# ---------------------------------------------------------------------------
# DWAA / DWAB
# ---------------------------------------------------------------------------

_DWA_UNKNOWN, _DWA_LOSSY_DCT, _DWA_RLE = 0, 1, 2
#: the natural index of each zig-zag position of an 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _dwa_rules(data: bytes, at: int, end: int):
    """Version 2's channel rules: (suffix, scheme, type, CSC index,
    case-insensitive) each, and the offset past them."""
    if at + 2 > end:
        raise _NoImage("DWA rules past the block")
    (size,) = struct.unpack_from("<H", data, at)
    stop = at + size
    if size < 2 or stop > end:
        raise _NoImage("DWA rules past the block")
    at += 2
    rules = []
    while at < stop:
        nul = data.find(b"\0", at, stop)
        if nul < 0 or nul + 3 > stop:
            raise _NoImage("bad DWA rule")
        suffix = data[at:nul].decode("latin-1")
        value, kind = data[nul + 1], data[nul + 2]
        csc, scheme = (value >> 4) - 1, (value >> 2) & 3
        if not -1 <= csc < 3 or scheme > 2 or kind > 2:
            raise _NoImage("bad DWA rule")
        rules.append((suffix, scheme, kind, csc, bool(value & 1)))
        at = nul + 3
    return rules, stop


def _dwa_classify(chans, rules):
    """``classifyChannels``: each channel's scheme by its name's last
    dotted part (the last matching rule wins), and the R/G/B sets of a
    common prefix and sampling, in the prefixes' byte order."""
    schemes, prefixes = [], {}
    for i, c in enumerate(chans):
        prefix, _, suffix = c["name"].rpartition(".")
        slots = prefixes.setdefault(prefix, [-1, -1, -1])
        scheme = _DWA_UNKNOWN
        for rule_suffix, rule_scheme, kind, csc, nocase in rules:
            same = (suffix.lower() == rule_suffix.lower()) if nocase else suffix == rule_suffix
            if same and kind == c["type"]:
                scheme = rule_scheme
                if csc >= 0:
                    slots[csc] = i
        schemes.append(scheme)
    sets = []
    for prefix in sorted(prefixes, key=lambda k: k.encode("latin-1")):
        r, g, b = prefixes[prefix]
        if min(r, g, b) < 0:
            continue
        if len({(chans[k]["xs"], chans[k]["ys"]) for k in (r, g, b)}) == 1:
            sets.append((r, g, b))
    return schemes, sets


def _dwa_to_linear() -> np.ndarray:
    """``dwaCompressorToLinear``: half bits of a nonlinear value -> half
    bits of the linear one: sign * |h| ** 2.2 up to 1, sign * (e **
    2.2) ** (|h| - 1) past it, in float32 (``powf``), 0 for Inf and NaN."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
        h = bits.view(np.float16).astype(np.float32)
        a = np.abs(h)
        log_base = np.float32(2.7182818 ** 2.2)
        with np.errstate(over="ignore", invalid="ignore"):
            low = np.power(a, np.float32(2.2))
            high = np.power(log_base, (a.astype(np.float64) - 1.0).astype(np.float32))
            v = np.where(a <= 1, low, high) * np.where(h < 0, np.float32(-1), np.float32(1))
            out = v.astype(np.float32).astype(np.float16).view(np.uint16)
        out = np.where((bits & 0x7C00) == 0x7C00, 0, out)
        out[0] = 0
        _TO_LINEAR = out.astype(np.uint16)
    return _TO_LINEAR


_TO_LINEAR = None
#: the constants of OpenEXR 2.3's SSE2 inverse DCT (``dctInverse8x8_sse2``),
#: .5 * cos(k * 3.14159 / 16) as decimals: a, b, c, d, e, f, g
_IDCT = dict(a=np.float32(3.535536e-01), b=np.float32(4.903927e-01),
             c=np.float32(4.619398e-01), d=np.float32(4.157349e-01),
             e=np.float32(2.777855e-01), f=np.float32(1.913422e-01),
             g=np.float32(9.754573e-02))


def _idct_rows(x):
    """The SSE2 row pass along the last axis of float32 (..., 8) arrays: a
    matrix product, each output's even and odd sums accumulated from zero
    in input order, then even + odd and even - odd reversed."""
    a, b, c, d, e, f, g = (_IDCT[k] for k in "abcdefg")
    even = (np.array([a, a, a, a], np.float32), np.array([c, f, -f, -c], np.float32),
            np.array([a, -a, -a, a], np.float32), np.array([f, -c, c, -f], np.float32))
    odd = (np.array([b, d, e, g], np.float32), np.array([d, -g, -b, -e], np.float32),
           np.array([e, -b, g, d], np.float32), np.array([g, -e, d, -b], np.float32))
    r = [x[..., k:k + 1] for k in range(8)]
    ev = np.float32(0) + r[0] * even[0]
    od = np.float32(0) + r[1] * odd[0]
    for k in range(1, 4):
        ev = ev + r[2 * k] * even[k]
        od = od + r[2 * k + 1] * odd[k]
    return np.concatenate([ev + od, (ev - od)[..., ::-1]], axis=-1)


def _idct_columns(x):
    """The SSE2 column pass along the last axis: the scalar version's
    factoring, the odd terms summed in pairs."""
    a, b, c, d, e, f, g = (_IDCT[k] for k in "abcdefg")
    r = [x[..., k] for k in range(8)]
    alpha0, alpha1, alpha2, alpha3 = c * r[2], f * r[2], c * r[6], f * r[6]
    beta0 = (r[1] * b + r[3] * d) + (r[5] * e + r[7] * g)
    beta1 = (r[1] * d - r[3] * g) - (r[5] * b + r[7] * e)
    beta2 = (r[1] * e - r[3] * b) + (r[5] * g + r[7] * d)
    beta3 = (r[1] * g - r[3] * e) + (r[5] * d - r[7] * b)
    theta0, theta3 = a * (r[0] + r[4]), a * (r[0] - r[4])
    theta1, theta2 = alpha0 + alpha3, alpha1 - alpha2
    gamma0, gamma1 = theta0 + theta1, theta3 + theta2
    gamma2, gamma3 = theta3 - theta2, theta0 - theta1
    return np.stack([gamma0 + beta0, gamma1 + beta1, gamma2 + beta2, gamma3 + beta3,
                     gamma3 - beta3, gamma2 - beta2, gamma1 - beta1, gamma0 - beta0], axis=-1)


def _idct_full(blocks):
    """``dctInverse8x8_sse2`` on (..., 8, 8) float32 blocks: the rows, then
    the columns (the path OpenEXR 2.3 takes on x86-64 in cv2 4.13's
    build, held bit for bit on the card's host)."""
    return np.swapaxes(_idct_columns(np.swapaxes(_idct_rows(blocks), -1, -2)), -1, -2)


def _dwa_lossy(ac: np.ndarray, ac_at: int, dc: np.ndarray, dc_at: int, ncomp: int,
               width: int, height: int, luts):
    """``LossyDctDecoder(Csc)::execute`` on ``ncomp`` planes of (height,
    width): per 8x8 block and plane the DC and the run-coded AC halves
    (0xffNN skips NN zeros, 0xff00 ends the block), the inverse DCT (a DC
    alone fills the block with dc * 0.3535536 * 0.3535536), the Rec. 709
    Y'CbCr -> RGB of a set of three, the float -> half rounding, each
    plane's LUT.  Returns the planes' half bits and the AC and DC
    positions past them."""
    bx, by = -(-width // 8), -(-height // 8)
    nblocks = bx * by
    if dc_at + ncomp * nblocks > len(dc):
        raise _NoImage("DWA DC values end early")
    zig = np.zeros((nblocks, ncomp, 64), np.uint16)
    last = np.zeros((nblocks, ncomp), bool)
    for comp in range(ncomp):
        zig[:, comp, 0] = dc[dc_at + comp * nblocks:dc_at + (comp + 1) * nblocks]
    acl = ac.tolist()
    at = ac_at
    for blk in range(nblocks):
        row = zig[blk]
        for comp in range(ncomp):
            k = 1
            while k < 64:
                if at >= len(acl):
                    raise _NoImage("DWA AC values end early")
                v = acl[at]
                at += 1
                if v == 0xFF00:
                    break
                if v >> 8 == 0xFF:
                    k += v & 0xFF
                else:
                    row[comp, k] = v
                    last[blk, comp] = True
                    k += 1
    vals = zig.view(np.float16).astype(np.float32)
    data = np.empty((nblocks, ncomp, 64), np.float32)
    data[:, :, _ZIGZAG] = vals
    blocks = data.reshape(nblocks, ncomp, 8, 8)
    with np.errstate(over="ignore", invalid="ignore"):
        full = _idct_full(blocks)
        dc_only = (vals[:, :, 0] * np.float32(3.535536e-01)) * np.float32(3.535536e-01)
        out = np.where(last[:, :, None, None], full, dc_only[:, :, None, None])
        if ncomp == 3:
            y, cb, cr = out[:, 0], out[:, 1], out[:, 2]
            out = np.stack([y + np.float32(1.5747) * cr,
                            (y - np.float32(0.1873) * cb) - np.float32(0.4682) * cr,
                            y + np.float32(1.8556) * cb], axis=1)
        bits = out.astype(np.float16).view(np.uint16)
    planes = bits.reshape(by, bx, ncomp, 8, 8).transpose(2, 0, 3, 1, 4).reshape(
        ncomp, by * 8, bx * 8)[:, :height, :width]
    return [lut[p] for lut, p in zip(luts, planes)], at, dc_at + ncomp * nblocks


def _dwa(data: bytes, geometry, chans, where: str) -> List[np.ndarray]:
    """A DWAA/DWAB block -> per channel (ny, nx) uint16 (HALF bits) or
    uint32 (UINT, FLOAT bits)."""
    if len(data) < 88:
        raise _NoImage("DWA block too short")
    (version, unk_raw, unk_size, ac_size, dc_size, rle_size, rle_raw, rle_bytes, ac_count,
     dc_count, ac_mode) = struct.unpack_from("<11q", data, 0)
    if version < 2:
        raise ValueError(f"{where}: OpenEXR DWA version {version} (format: OpenEXR): the "
                         "port reads version 2, which OpenEXR 2.2 and later write")
    if version > 2 or min(unk_raw, unk_size, ac_size, dc_size, rle_size, rle_raw,
                          rle_bytes, ac_count, dc_count) < 0:
        raise _NoImage("bad DWA header")
    rules, at = _dwa_rules(data, 88, len(data))
    if at + unk_size + ac_size + dc_size + rle_size > len(data):
        raise _NoImage("DWA data past the block")
    schemes, sets = _dwa_classify(chans, rules)
    unknown = _zlib(data[at:at + unk_size], unk_raw) if unk_size else b""
    at += unk_size
    if ac_size:
        if ac_mode == 0:
            ac = _huf_decode(data, at, ac_size, ac_count)
        elif ac_mode == 1:
            ac = np.frombuffer(_zlib(data[at:at + ac_size], 2 * ac_count), "<u2")
        else:
            raise _NoImage("unknown DWA AC coding")
    else:
        ac = np.zeros(0, np.uint16)
    at += ac_size
    dc = np.frombuffer(_unpredict(np.frombuffer(_zlib(data[at:at + dc_size], 2 * dc_count),
                                                np.uint8)), "<u2") if dc_size else \
        np.zeros(0, np.uint16)
    at += dc_size
    rle = _rle(_zlib(data[at:at + rle_size], rle_raw), rle_bytes) if rle_size else \
        np.zeros(0, np.uint8)
    out: List[Optional[np.ndarray]] = [None] * len(chans)
    ac_at = dc_at = 0
    lut = _dwa_to_linear()
    identity = np.arange(65536, dtype=np.uint32).astype(np.uint16)

    def finish(i, bits):
        if chans[i]["type"] == _HALF:
            return bits
        return bits.view(np.float16).astype(np.float32).view(np.uint32)

    done = set()
    for group in sets:  # OpenEXR takes an R/G/B set as nonlinear, whatever its flags
        nx, ny, _ = geometry[group[0]]
        planes, ac_at, dc_at = _dwa_lossy(ac, ac_at, dc, dc_at, 3, nx, ny, [lut] * 3)
        for i, plane in zip(group, planes):
            out[i] = finish(i, plane)
        done.update(group)
    unk_at = rle_at = 0
    unknown = np.frombuffer(unknown, np.uint8)
    for i, (c, (nx, ny, kind)) in enumerate(zip(chans, geometry)):
        if i in done:
            continue
        size = _SIZES[kind]
        if schemes[i] == _DWA_LOSSY_DCT:
            planes, ac_at, dc_at = _dwa_lossy(ac, ac_at, dc, dc_at, 1, nx, ny, [
                identity if c["linear"] else lut])
            out[i] = finish(i, planes[0])
        elif schemes[i] == _DWA_RLE:
            n = nx * ny
            part = rle[rle_at:rle_at + n * size]
            if len(part) != n * size:
                raise _NoImage("DWA RLE data end early")
            rle_at += n * size
            raw = np.ascontiguousarray(part.reshape(size, n).T).view("<u4" if size == 4
                                                                     else "<u2")
            out[i] = raw.reshape(ny, nx).astype(np.uint16 if kind == _HALF else np.uint32)
        else:
            part = unknown[unk_at:unk_at + nx * ny * size]
            if len(part) != nx * ny * size:
                raise _NoImage("DWA UNKNOWN data end early")
            unk_at += nx * ny * size
            raw = part.view("<u2" if kind == _HALF else "<u4").reshape(ny, nx)
            out[i] = raw.astype(np.uint16 if kind == _HALF else np.uint32)
    return out


# ---------------------------------------------------------------------------
# blocks -> channels
# ---------------------------------------------------------------------------

def _uncompress(part, data: bytes, x0: int, x1: int, y0: int, y1: int, where: str
                ) -> List[np.ndarray]:
    """One chunk's samples: per channel a (ny, nx) array of uint32 (UINT,
    FLOAT bits) or uint16 (HALF bits).  A chunk no shorter than its
    samples is raw, whatever the compression, as OpenEXR reads it."""
    chans = part["channels"]
    geometry = _geometry(chans, x0, x1, y0, y1)
    size = sum(nx * ny * _SIZES[k] for nx, ny, k in geometry)
    comp = part["compression"]
    lines = [(y, [(i, geometry[i][0]) for i, c in enumerate(chans) if y % c["ys"] == 0])
             for y in range(y0, y1 + 1)]
    if len(data) >= size or comp == 0:
        if len(data) != size:
            raise _NoImage("raw block of the wrong size")
        raw = data
    elif comp >= 8:
        return _dwa(data, geometry, chans, where)
    elif comp == 1:
        raw = _unpredict(_rle(data, size))
    elif comp in (2, 3):
        raw = _unpredict(np.frombuffer(_zlib(data, size), np.uint8))
    elif comp == 5:
        total = sum(nx * ny * {_UINT: 4, _HALF: 2, _FLOAT: 3}[k] for nx, ny, k in geometry)
        return _pxr24(_zlib(data, total), geometry, lines)
    else:
        planes = _piz(data, geometry) if comp == 4 else _b44(data, geometry, chans, where)
        return [_from_shorts(p, kind) for p, (_, _, kind) in zip(planes, geometry)]
    return _split_lines(np.frombuffer(raw, np.uint8), chans, geometry, lines)


def _from_shorts(plane: np.ndarray, kind: int) -> np.ndarray:
    if kind == _HALF:
        return plane
    p = plane.astype(np.uint32)
    return p[:, 0::2] | (p[:, 1::2] << 16)


def _split_lines(buf: np.ndarray, chans, geometry, lines) -> List[np.ndarray]:
    """The line-interleaved layout (each line, each channel sampled on
    it) -> per channel (ny, nx)."""
    dtypes = {_UINT: "<u4", _HALF: "<u2", _FLOAT: "<u4"}
    if all(c["ys"] == 1 for c in chans):
        widths = [nx * _SIZES[k] for nx, _, k in geometry]
        rows = buf.reshape(len(lines), sum(widths))
        out, at = [], 0
        for (nx, ny, kind), wb in zip(geometry, widths):
            out.append(np.ascontiguousarray(rows[:, at:at + wb]).view(dtypes[kind]).astype(
                np.uint16 if kind == _HALF else np.uint32))
            at += wb
        return out
    per = [[] for _ in chans]
    at = 0
    for _, present in lines:
        for i, nx in present:
            kind = geometry[i][2]
            n = nx * _SIZES[kind]
            per[i].append(buf[at:at + n].view(dtypes[kind]))
            at += n
    return [np.stack(p).astype(np.uint16 if g[2] == _HALF else np.uint32) if p
            else np.zeros((0, g[0]), np.uint32) for p, g in zip(per, geometry)]


def _to_float(samples: np.ndarray, kind: int) -> np.ndarray:
    if kind == _HALF:
        return samples.astype(np.uint16).view(np.float16).astype(np.float32)
    if kind == _FLOAT:
        return samples.astype(np.uint32).view(np.float32)
    return samples.astype(np.uint32).astype(np.float32)


def _read_chunks(data: bytes, part, table: np.ndarray, multi: bool, where: str
                 ) -> List[np.ndarray]:
    """Every channel of the part, float32, on its sample grid."""
    chans = part["channels"]
    w, h, x0, y0 = part["w"], part["h"], part["x0"], part["y0"]
    grids = [np.zeros((_num_samples(c["ys"], y0, y0 + h - 1),
                       _num_samples(c["xs"], x0, x0 + w - 1)), np.float32) for c in chans]
    head = 4 if multi else 0

    def chunk(k, fields):
        at = int(table[k])
        if at <= 0 or at + head + 4 * fields + 4 > len(data):
            raise _NoImage("chunk offset past the file")
        if multi and struct.unpack_from("<i", data, at)[0] != 0:
            raise _NoImage("chunk of another part")
        vals = struct.unpack_from(f"<{fields}i", data, at + head)
        (size,) = struct.unpack_from("<i", data, at + head + 4 * fields)
        start = at + head + 4 * fields + 4
        if size < 0 or start + size > len(data):
            raise _NoImage("chunk data past the file")
        return vals, data[start:start + size]

    if part["tile"] is None:
        step = _BLOCK_LINES[part["compression"]]
        for k in range(len(table)):
            (ys,), body = chunk(k, 1)
            b0 = y0 + k * step
            if ys != b0:
                raise _NoImage("scanline chunk out of place")
            b1 = min(b0 + step, y0 + h) - 1
            got = _uncompress(part, body, x0, x0 + w - 1, b0, b1, where)
            for i, c in enumerate(chans):
                r0 = _num_samples(c["ys"], y0, b0 - 1) if b0 > y0 else 0
                grids[i][r0:r0 + got[i].shape[0]] = _to_float(got[i], c["type"])
        return grids
    tx, ty = part["tile"][:2]
    nx_tiles = -(-w // tx)
    for k in range(_level_tiles(part)):
        (i_t, j_t, lx, ly), body = chunk(k, 4)
        if (i_t, j_t, lx, ly) != (k % nx_tiles, k // nx_tiles, 0, 0):
            raise _NoImage("tile out of place")
        ax, ay = x0 + i_t * tx, y0 + j_t * ty
        bx, by = min(ax + tx, x0 + w) - 1, min(ay + ty, y0 + h) - 1
        got = _uncompress(part, body, ax, bx, ay, by, where)
        for i, c in enumerate(chans):
            grids[i][ay - y0:by - y0 + 1, ax - x0:bx - x0 + 1] = _to_float(got[i], c["type"])
    return grids


def _decode_channels(data: bytes, where: str) -> Tuple[Dict, List[np.ndarray]]:
    """The first part's header and channels (float32 sample grids)."""
    if len(data) < 8:
        raise _NoImage("no version field")
    (version,) = struct.unpack_from("<I", data, 4)
    flags = version & ~0xFF
    if version & 0xFF != 2 or flags & ~_KNOWN_FLAGS:
        raise _NoImage("unknown version or flags")
    limit = 255 if flags & 0x400 else 31
    multi = bool(flags & 0x1000)
    at = 8
    parts = []
    while True:
        attrs, at = _attributes(data, at, limit)
        parts.append(attrs)
        if not multi or at >= len(data) or data[at] == 0:
            at += 1 if multi else 0
            break
    if len(parts) > 1:
        raise _NoImage("a multi-part file of more than one part")
    part = _part(parts[0], bool(flags & 0x200), limit)
    if (flags & 0x800 and not multi) or (part["kind"] or "").startswith("deep"):
        raise ValueError(f"{where}: OpenEXR deep data (format: OpenEXR): cv2 reads a deep "
                         "scanline file's composite, the port does not")
    length = _table_length(part)
    if at + 8 * length > len(data):
        raise _NoImage("offset table past the file")
    table = np.frombuffer(data, "<i8", length, at)
    if (table <= 0).any():
        table = _reconstruct(data, part, at + 8 * length, length, multi)
    return part, _read_chunks(data, part, table, multi, where)


def _reconstruct(data: bytes, part, at: int, length: int, multi: bool) -> np.ndarray:
    """OpenEXR's repair of an offset table with an entry <= 0 (a file
    whose writer stopped): the chunks after the table walked in order,
    each put where its coordinates say; entries never found stay 0."""
    table = np.zeros(length, np.int64)
    head = 4 if multi else 0
    fields = 1 if part["tile"] is None else 4
    nx_tiles = None if part["tile"] is None else -(-part["w"] // part["tile"][0])
    for i in range(length):
        if at + head + 4 * fields + 4 > len(data):
            break
        vals = struct.unpack_from(f"<{fields}i", data, at + head)
        (size,) = struct.unpack_from("<i", data, at + head + 4 * fields)
        if part["tile"] is None:
            table[i if part["order"] != 1 else length - 1 - i] = at
        elif vals[2:] == (0, 0) and 0 <= vals[0] < nx_tiles and vals[1] >= 0:
            k = vals[1] * nx_tiles + vals[0]
            if k < _level_tiles(part):
                table[k] = at
        if size < 0:
            break
        at += head + 4 * fields + 4 + size
    return table


# ---------------------------------------------------------------------------
# what cv2 makes of the channels
# ---------------------------------------------------------------------------

#: ``Imf::Chromaticities()``'s default (Rec. ITU-R BT.709): red, green,
#: blue, white (x, y)
_REC709 = (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290)


def _full(grid: np.ndarray, c: Dict, h: int, w: int) -> np.ndarray:
    """cv2's ``UpSample``: each sample repeated over its sampling block."""
    return np.repeat(np.repeat(grid, c["ys"], axis=0), c["xs"], axis=1)[:h, :w]


def _chroma_to_bgr(b, y, r, chroma):
    """``ExrDecoder::ChromaToBGR`` in float64, stored as float32: r and b
    are (chroma + 1) * Y, g solves Y for the primaries' y values."""
    b, y, r = (np.asarray(v, np.float64) for v in (b, y, r))
    cr, cg, cb = (float(np.float32(chroma[k])) for k in (1, 3, 5))
    with np.errstate(invalid="ignore", over="ignore"):
        r = (r + 1) * y
        b = (b + 1) * y
        g = (y - b * cb - r * cr) / cg
    return [v.astype(np.float32) for v in (b, g, r)]


def _to_u8(v: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>(float)``: rounded half to even; NaN, +-Inf
    and magnitudes past 2**31 (x86's integer indefinite) give 0."""
    v = np.asarray(v, np.float32).astype(np.float64)
    with np.errstate(invalid="ignore"):
        ok = np.isfinite(v) & (np.abs(np.rint(v)) < 2.0 ** 31)
        return np.where(ok, np.clip(np.rint(np.where(ok, v, 0)), 0, 255), 0).astype(np.uint8)


def _to_cv2(part, grids, color: bool) -> Optional[np.ndarray]:
    """cv2's image of the channels.  R, G or B makes a BGR image, the
    missing ones 0; otherwise Y makes luminance/chroma with RY and BY (a
    grey image without them), or, failing Y, a channel named Z makes a
    grey image of zeros (cv2 takes it but reads Y); anything else gives
    None.  A is kept as the last channel in ``IMREAD_UNCHANGED`` (BGRA,
    or grey and alpha), never in ``IMREAD_COLOR``.

    ``IMREAD_UNCHANGED`` is float32: subsampled channels repeated,
    luminance/chroma with RY or BY turned to BGR (:func:`_chroma_to_bgr`,
    the primaries' y from the file's chromaticities, Rec. 709 without).
    ``IMREAD_COLOR`` reads line by line into one line of floats: each
    value rounded to uint8 (:func:`_to_u8`); luminance, with or without
    chroma, goes through the BGR conversion, a missing channel's slot
    filled with 0 on every line, and a line on which a subsampled chroma
    channel has no samples converts what the line before left in its slot
    (the converted b or r); then cv2 repeats the rows of each subsampled
    channel's slot over its sampling."""
    chans = part["channels"]
    h, w = part["h"], part["w"]
    by_name = {c["name"]: (c, g) for c, g in zip(chans, grids)}

    def full(name):
        if name not in by_name:
            return np.zeros((h, w), np.float32)
        c, g = by_name[name]
        return _full(g, c, h, w)

    alpha = "A" in by_name and not color
    if any(n in by_name for n in "RGB"):
        planes = [full(n) for n in "BGR"]
        if color:
            return np.stack([_to_u8(p) for p in planes], axis=-1)
        return np.stack(planes + [full("A")] if alpha else planes, axis=-1)
    if "Y" not in by_name and "Z" not in by_name:
        return None
    luma = "Y" if "Y" in by_name else None
    chroma = part["chroma"] or _REC709
    if not color:
        y = full(luma) if luma else np.zeros((h, w), np.float32)
        if luma and ("RY" in by_name or "BY" in by_name):
            planes = _chroma_to_bgr(full("BY"), y, full("RY"), chroma)
            return np.stack(planes + [full("A")] if alpha else planes, axis=-1)
        return np.stack([y, full("A")], axis=-1) if alpha else y
    slots = ["BY", luma, "RY"]
    out = np.zeros((h, w, 3), np.uint8)
    line = [np.zeros(w, np.float32) for _ in slots]
    y0 = part["y0"]
    for row in range(h):
        for k, name in enumerate(slots):
            if name is None or name not in by_name:
                line[k] = np.zeros(w, np.float32)  # OpenEXR fills it each line
                continue
            c, g = by_name[name]
            if (y0 + row) % c["ys"] == 0:
                r0 = (y0 + row) // c["ys"] - y0 // c["ys"]
                line[k] = np.repeat(g[r0], c["xs"])[:w]
            elif c["xs"] > 1:  # cv2 repeats the stale slot's samples again
                line[k] = np.repeat(line[k][:-(-w // c["xs"])], c["xs"])[:w]
        line = _chroma_to_bgr(*line, chroma)
        out[row] = np.stack([_to_u8(v) for v in line], axis=-1)
    for k, name in enumerate(slots):
        if name in by_name and by_name[name][0]["ys"] > 1:
            ys = by_name[name][0]["ys"]
            out[:, :, k] = np.repeat(out[::ys, :, k], ys, axis=0)[:h]
    return out


def _decode(data: bytes, source: Optional[str], color: bool) -> Optional[np.ndarray]:
    _check_gate(source)
    where = _where(source)
    try:
        part, grids = _decode_channels(data, where)
    except _NoImage:
        return None
    return _to_cv2(part, grids, color)


def decode_unchanged(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``cv2.imdecode`` / ``cv2.imread`` with ``IMREAD_UNCHANGED``: float32
    (H, W) grey, (H, W, 2) grey and alpha, (H, W, 3) BGR or (H, W, 4)
    BGRA; None where cv2 reads no image."""
    return _decode(data, source, False)


def decode_color(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``IMREAD_COLOR`` then RGB: (H, W, 3) uint8; None where cv2 reads
    no image."""
    img = _decode(data, source, True)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])
