"""JPEG decoding in numpy, as libjpeg-turbo decodes for cv2.

The reference reads JPEG images through cv2 (``diffdope_tpu/image.py:55-
77``, ``mesh.py:1030-1037``, ``mesh.py:417-438``), and cv2 through
libjpeg-turbo with its defaults, which are integer arithmetic throughout.
:func:`decode_jpeg` repeats that arithmetic and so returns cv2's arrays
bit for bit: (H, W, 3) BGR uint8 for a colour file, (H, W) uint8 for a
grey one (``cv2.imread(path, IMREAD_UNCHANGED)``; ``png.py`` replicates
grey and applies the EXIF orientation for ``IMREAD_COLOR``).

- Entropy decoding: baseline and extended sequential Huffman at 8 bits,
  and progressive (spectral selection, successive approximation of DC
  and AC, EOB runs, correction bits); restart intervals, byte stuffing
  and fill bytes.  This is the one part that loops in Python, a symbol at
  a time, through 16-bit lookup tables that also fold in the magnitude
  bits of a symbol whose code and bits fit in 16 (:func:`_fast_table`).
- Dequantisation and ``jidctint.c``'s ISLOW IDCT (CONST_BITS 13,
  PASS1_BITS 2, DESCALE rounding) in the form cv2 runs on x86,
  libjpeg-turbo's SIMD code: its 16-bit lanes wrap and saturate, and its
  samples saturate, where ``jidctint.c`` would index the range-limit
  table of ``jdmaster.c:prepare_range_limit_table`` with a wrap (``&
  RANGE_MASK``).  The two agree on every file an encoder writes and part
  only past that range (:func:`_idct_islow`).  Vectorised over all blocks.
- ``jdsample.c``'s upsampling: fancy h2v1, h2v2 (biases 8 and 7) and h1v2,
  box replication otherwise (and for fancy h2 on a plane two samples wide
  or less), each extending the right and bottom edges by replication.
- ``jdcolor.c``'s YCbCr -> RGB in 16-bit fixed point, or RGB as stored
  (an Adobe marker with transform 0, or component ids 'R' 'G' 'B').

A progressive file whose first AC coefficients are left unrefined would
be block-smoothed by libjpeg (``jdcoefct.c``, ``smoothing_ok``); such a
file raises.  So do arithmetic coding, 12-bit samples, lossless and
hierarchical frames and 2- or 4-component (CMYK/YCCK) files, each by name.
"""

from __future__ import annotations

import functools
import struct
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\xff\xd8\xff"

#: zigzag index -> natural (row-major) index of an 8x8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
#: natural index of zigzag k, with libjpeg's 16 spare entries at 63 so a
#: corrupt run lands in the block
_NAT = _NATURAL.tolist() + [63] * 16
#: _NAT shifted by one: the natural index of zigzag k - 1
_NAT1 = [0] + _NAT

#: frame markers other than the three Huffman 8-bit ones -> the variant
_REFUSED_FRAMES = {
    0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic coding", 0xCA: "arithmetic coding (progressive)",
    0xCB: "arithmetic coding (lossless)", 0xCD: "arithmetic coding (hierarchical)",
    0xCE: "arithmetic coding (hierarchical progressive)",
    0xCF: "arithmetic coding (hierarchical lossless)",
}

# jidctint.c's constants: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 2**16 +
    0.5 truncated, ONE_HALF folded into the Cb->G table."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = (t.astype(np.int32) for t in _ycc_tables())
#: jdmaster.c's sample_range_limit from -256 on: x -> x clamped to [0, 255]
_CLAMP = np.clip(np.arange(-256, 768), 0, 255).astype(np.uint8)


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


class _Corrupt(Exception):
    """A table or entropy-coded data that no valid file holds."""


# ---------------------------------------------------------------------------
# markers and Huffman tables
# ---------------------------------------------------------------------------

def _segments(data: bytes, source: Optional[str]):
    """(marker, body start, body end) of each marker segment from SOI on;
    an SOS's end is that of its header (the entropy-coded data follows
    and is found by :func:`_entropy_segment`)."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{_where(source)}: not a JPEG file")
    at = 2
    n = len(data)
    while at < n:
        if data[at] != 0xFF:
            raise _Corrupt(f"a marker expected at byte {at}")
        while at < n and data[at] == 0xFF:  # fill bytes before a marker
            at += 1
        if at >= n:
            return
        marker = data[at]
        at += 1
        if marker == 0xD9:  # EOI
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # stray RSTn or TEM
            continue
        if at + 2 > n:
            raise _Corrupt("a truncated marker segment")
        (length,) = struct.unpack(">H", data[at:at + 2])
        end = at + length
        if length < 2 or end > n:
            raise _Corrupt("a truncated marker segment")
        at = yield marker, at + 2, end
        if at is None:
            at = end


def exif(data: bytes) -> bytes:
    """The TIFF block of the file's first APP1 segment (past its six-byte
    ``Exif\\0\\0`` header), as cv2 takes it for the EXIF orientation; b""
    without one."""
    try:
        for marker, start, end in _segments(data, None):
            if marker == 0xE1:
                return data[start + 6:end] if end - start > 6 else b""
            if marker == 0xDA:
                break
    except _Corrupt:
        pass
    return b""


def _huffman_codes(counts: bytes, symbols: bytes):
    """The canonical codes of a DHT table -> [(code, length, symbol)]
    (``jdhuff.c:jpeg_make_d_derived_tbl``)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((code, length, symbols[k]))
            code += 1
            k += 1
        if code > (1 << length):
            raise _Corrupt("a Huffman table with more codes than its lengths allow")
        code <<= 1
    return out


def _extend(bits: np.ndarray, s) -> np.ndarray:
    """HUFF_EXTEND: s magnitude bits -> the signed value."""
    s = np.asarray(s)
    return np.where(bits < (1 << np.maximum(s - 1, 0)), bits - (1 << s) + 1, bits) * (s > 0)


@functools.lru_cache(maxsize=64)
def _fast_table(counts: bytes, symbols: bytes, is_dc: bool) -> List[Tuple[int, int, int]]:
    """The next 16 bits of the stream -> (bits used, step, value).

    DC: step 1 with the decoded difference when code and magnitude bits
    fit in 16 (bits used covers both); else step -1 - s, the s magnitude
    bits to read after the code.  AC (symbol r << 4 | s): s > 0 that fits
    gives step r + 1 and the coefficient; ZRL (15, 0) step 16, value 0;
    an EOB run (r < 15, s = 0) step 0 and value r; s > 0 that does not
    fit gives step -1 - symbol.  A prefix of no code raises when met."""
    n = np.zeros(1 << 16, np.int64)
    step = np.full(1 << 16, -1000, np.int64)
    val = np.zeros(1 << 16, np.int64)
    for code, length, sym in _huffman_codes(counts, symbols):
        lo, hi = code << (16 - length), (code + 1) << (16 - length)
        idx = np.arange(lo, hi)
        s = sym if is_dc else sym & 15
        r = 0 if is_dc else sym >> 4
        if not is_dc and s == 0:
            n[lo:hi] = length
            step[lo:hi] = 16 if r == 15 else 0
            val[lo:hi] = 0 if r == 15 else r
        elif length + s <= 16:
            bits = (idx >> (16 - length - s)) & ((1 << s) - 1)
            n[lo:hi] = length + s
            step[lo:hi] = 1 if is_dc else r + 1
            val[lo:hi] = _extend(bits, s)
        else:
            n[lo:hi] = length
            step[lo:hi] = -1 - sym
    return list(zip(n.tolist(), step.tolist(), val.tolist()))


@functools.lru_cache(maxsize=64)
def _symbol_table(counts: bytes, symbols: bytes) -> List[Tuple[int, int]]:
    """The next 16 bits -> (code length, symbol); length 0 for no code."""
    n = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    for code, length, s in _huffman_codes(counts, symbols):
        lo, hi = code << (16 - length), (code + 1) << (16 - length)
        n[lo:hi] = length
        sym[lo:hi] = s
    return list(zip(n.tolist(), sym.tolist()))


# ---------------------------------------------------------------------------
# entropy-coded data
# ---------------------------------------------------------------------------

def _entropy_segment(arr: np.ndarray, start: int):
    """The entropy-coded data from ``start`` to the next marker that is not
    RSTn -> (its bytes unstuffed as 32-bit windows, one a byte: the byte
    and the three after it; the unstuffed offset where each restart
    interval begins; the offset of that marker).  A 0xFF 0x00 is a data
    0xFF, fill 0xFF bytes before a marker are dropped."""
    tail = arr[start:]
    ff = np.flatnonzero(tail[:-1] == 0xFF)
    nxt = tail[ff + 1]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    stop = ff[(nxt != 0x00) & (nxt != 0xFF) & ~is_rst]
    end = int(stop[0]) if len(stop) else len(tail)
    inside = ff < end
    ff, nxt, is_rst = ff[inside], nxt[inside], is_rst[inside]
    keep = np.ones(end, bool)
    keep[ff[nxt == 0xFF]] = False  # a fill byte
    keep[ff[nxt == 0x00] + 1] = False  # the stuffed zero
    rst = ff[is_rst]
    keep[rst] = False
    keep[rst + 1] = False
    data = tail[:end][keep]
    kept_before = np.concatenate([[0], np.cumsum(keep)])
    starts = [0] + kept_before[rst + 2].tolist()
    b = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.uint32)
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    return win, starts, start + end


def _bad_code():
    raise _Corrupt("a Huffman code that is in no table")


def _get(win, pos, s):
    """s bits (s <= 16) at bit ``pos`` of the window list."""
    return (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)


def _extend1(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_sequential(win, starts, blocks, per_interval, coefs, ncomp):
    """Baseline/extended sequential scan (``jdhuff.c:decode_mcu``).
    ``blocks`` lists (coefficient base, component, DC table, AC table) in
    scan order; each restart interval of ``per_interval`` blocks starts
    at its own byte and with zero DC predictors."""
    nat1 = _NAT1
    for seg, i0 in enumerate(range(0, len(blocks), per_interval)):
        pos = starts[seg] * 8
        pred = [0] * ncomp
        for base, c, dct, act in blocks[i0:i0 + per_interval]:
            n, step, v = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += n
            if step < 0:
                if step == -1000:
                    _bad_code()
                s = -1 - step
                v = _extend1(_get(win, pos, s), s)
                pos += s
            v += pred[c]
            pred[c] = v
            coefs[base] = v
            k = 1
            while k < 64:
                n, step, v = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += n
                if step > 0:
                    k += step
                    if v:
                        coefs[base + nat1[k]] = v
                elif step == 0:
                    break
                else:
                    if step == -1000:
                        _bad_code()
                    sym = -1 - step
                    s = sym & 15
                    v = _extend1(_get(win, pos, s), s)
                    pos += s
                    k += (sym >> 4) + 1
                    coefs[base + nat1[k]] = v


def _decode_dc_first(win, starts, blocks, per_interval, coefs, ncomp, al):
    """Progressive DC first scan (``jdphuff.c:decode_mcu_DC_first``)."""
    for seg, i0 in enumerate(range(0, len(blocks), per_interval)):
        pos = starts[seg] * 8
        pred = [0] * ncomp
        for base, c, dct, _ in blocks[i0:i0 + per_interval]:
            n, step, v = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += n
            if step < 0:
                if step == -1000:
                    _bad_code()
                s = -1 - step
                v = _extend1(_get(win, pos, s), s)
                pos += s
            v += pred[c]
            pred[c] = v
            coefs[base] = v << al


def _decode_dc_refine(win, starts, blocks, per_interval, coefs, al):
    """Progressive DC refinement (``decode_mcu_DC_refine``): one bit each."""
    p1 = 1 << al
    for seg, i0 in enumerate(range(0, len(blocks), per_interval)):
        pos = starts[seg] * 8
        for base, _, _, _ in blocks[i0:i0 + per_interval]:
            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                coefs[base] |= p1
            pos += 1


def _decode_ac_first(win, starts, blocks, per_interval, coefs, ss, se, al):
    """Progressive AC first scan of one component, with EOB runs
    (``decode_mcu_AC_first``)."""
    nat1 = _NAT1
    for seg, i0 in enumerate(range(0, len(blocks), per_interval)):
        pos = starts[seg] * 8
        eobrun = 0
        for base, _, _, act in blocks[i0:i0 + per_interval]:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                n, step, v = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += n
                if step > 0:
                    k += step
                    if v:
                        coefs[base + nat1[k]] = v * (1 << al)
                elif step == 0:
                    eobrun = 1 << v
                    if v:
                        eobrun += _get(win, pos, v)
                        pos += v
                    eobrun -= 1
                    break
                else:
                    if step == -1000:
                        _bad_code()
                    sym = -1 - step
                    s = sym & 15
                    v = _extend1(_get(win, pos, s), s)
                    pos += s
                    k += (sym >> 4) + 1
                    coefs[base + nat1[k]] = v * (1 << al)


def _decode_ac_refine(win, starts, blocks, per_interval, coefs, ss, se, al):
    """Progressive AC refinement of one component: new coefficients of
    magnitude 1 << al and a correction bit for each coefficient already
    nonzero that the run passes (``decode_mcu_AC_refine``)."""
    nat = _NAT
    p1, m1 = 1 << al, -1 << al
    for seg, i0 in enumerate(range(0, len(blocks), per_interval)):
        pos = starts[seg] * 8
        eobrun = 0
        for base, _, _, tab in blocks[i0:i0 + per_interval]:
            k = ss
            if eobrun == 0:
                while k <= se:
                    length, sym = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not length:
                        _bad_code()
                    pos += length
                    r, s = sym >> 4, sym & 15
                    if s:
                        s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += _get(win, pos, r)
                            pos += r
                        break
                    while k <= se:
                        at = base + nat[k]
                        c = coefs[at]
                        if c:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                                coefs[at] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        coefs[base + nat[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + nat[k]
                    c = coefs[at]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            coefs[at] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    k += 1
                eobrun -= 1


# ---------------------------------------------------------------------------
# IDCT, upsampling, colour
# ---------------------------------------------------------------------------

def _wrap16(x):
    """x modulo 2**16 as a signed 16-bit value (numpy's cast wraps)."""
    return x.astype(np.int16).astype(np.int64)


def _idct_1d(x):
    """One 1-D pass of the ISLOW IDCT on x[0..7] (int64 arrays of int16
    values) -> the eight sums before DESCALE, in output order.

    jidctint.c's products, regrouped as libjpeg-turbo's SIMD form does
    (``jidctint-avx2.asm``): every pair of products is one 16 x 16 -> 32
    multiply-add, which is exact, but x0 +- x4, x7 + x3 and x5 + x1 are
    16-bit adds and wrap."""
    tmp3 = x[2] * (_F0541 + _F0765) + x[6] * _F0541
    tmp2 = x[2] * _F0541 + x[6] * (_F0541 - _F1847)
    tmp0 = _wrap16(x[0] + x[4]) << _CONST_BITS
    tmp1 = _wrap16(x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(x[7] + x[3]), _wrap16(x[5] + x[1])
    z3, z4 = z3 * (_F1175 - _F1961) + z4 * _F1175, z3 * _F1175 + z4 * (_F1175 - _F0390)
    tmp0 = x[7] * (_F0298 - _F0899) - x[1] * _F0899 + z3
    tmp1 = x[5] * (_F2053 - _F2562) - x[3] * _F2562 + z4
    tmp2 = x[3] * (_F3072 - _F2562) - x[5] * _F2562 + z3
    tmp3 = x[1] * (_F1501 - _F0899) - x[7] * _F0899 + z4
    return (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)


def _descale(x, n):
    """DESCALE in a 32-bit lane (the sum wraps), saturated to 16 bits as
    the pass's pack does."""
    x = x + (1 << (n - 1))
    x = ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return np.clip(x >> n, -32768, 32767)


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The ISLOW IDCT of (..., 8, 8) coefficients in natural order with an
    (8, 8) quantisation table -> (..., 8, 8) uint8 samples, as cv2's
    libjpeg-turbo computes it with its x86 SIMD code (SSE2 and AVX2 alike).

    Columns first (PASS1_BITS kept), then rows, as ``jidctint.c``.  The
    SIMD code keeps its values in 16-bit lanes where jidctint.c has 64-bit
    ones: the dequantised coefficients and the sums of :func:`_idct_1d`
    wrap at 16 bits, each pass's results saturate at 16 bits, a block
    whose coefficients past the first row are all zero takes pass 1 as
    the dequantised first row shifted left by PASS1_BITS in 16 bits, and
    the samples saturate at 0 and 255 where jidctint.c indexes
    ``prepare_range_limit_table``'s table with ``x & RANGE_MASK``, which
    wraps past +-512.  Every value of a file an encoder writes stays in
    the range where the two agree (|x| < 512, no 16-bit overflow); a file
    whose quantisation table was scaled past it, as the tests make,
    shows cv2's values."""
    shape = coefs.shape
    k = _wrap16(coefs.reshape(-1, 8, 8).astype(np.int64))
    x = _wrap16(k * _wrap16(quant.astype(np.int64)))
    out = np.empty(k.shape, np.uint8)
    row0 = ~k[:, 1:, :].any(axis=(1, 2))  # pass 1's shortcut: every row but the first 0
    full = ~row0
    xf = x[full]
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS)
                   for v in _idct_1d([xf[:, r, :] for r in range(8)])], axis=1)
    out[full] = _samples(_idct_1d([ws[:, :, c] for c in range(8)]), axis=2)
    # the shortcut's eight equal rows: pass 2 on one of them
    w = _wrap16(x[row0][:, 0, :] << _PASS1_BITS)
    out[row0] = _samples(_idct_1d([w[:, c] for c in range(8)]), axis=1)[:, None, :]
    return out.reshape(shape)


def _samples(sums, axis):
    """Pass 2's sums -> uint8 samples: DESCALE, then the 8-bit saturation
    and the +128 level shift."""
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3) for v in sums], axis=axis)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _rep(a, axis, before):
    """a shifted by one along ``axis``, the edge sample repeated."""
    n = a.shape[axis]
    idx = np.concatenate([[0], np.arange(n - 1)]) if before else \
        np.concatenate([np.arange(1, n), [n - 1]])
    return np.take(a, idx, axis=axis)


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """``jdsample.c``'s upsampling of one component plane (its downsampled
    width and height) by integer factors, fancy where libjpeg is:
    h2v1 (width > 2), h1v2, h2v2 (width > 2); box replication otherwise."""
    x = plane.astype(np.int32)
    if fh == 2 and fv == 1 and x.shape[1] > 2:
        three = 3 * x
        out = _interleave((three + _rep(x, 1, True) + 1) >> 2,
                          (three + _rep(x, 1, False) + 2) >> 2, 1)
    elif fh == 1 and fv == 2:
        three = 3 * x
        out = _interleave((three + _rep(x, 0, True) + 1) >> 2,
                          (three + _rep(x, 0, False) + 2) >> 2, 0)
    elif fh == 2 and fv == 2 and x.shape[1] > 2:
        three = 3 * x
        rows = _interleave(three + _rep(x, 0, True), three + _rep(x, 0, False), 0)
        three = 3 * rows
        out = _interleave((three + _rep(rows, 1, True) + 8) >> 4,
                          (three + _rep(rows, 1, False) + 7) >> 4, 1)
    else:
        out = np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
    return out.astype(np.uint8)


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c:ycc_rgb_convert`` to cv2's BGR order (uint8 planes in),
    its range limit a clamp to [0, 255] (the sums stay in [-227, 434])."""
    y = y.astype(np.int32) + 256  # the offset into _CLAMP
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CB_B[cb]]
    out[..., 1] = _CLAMP[y + ((_CB_G[cb] + _CR_G[cr]) >> 16)]
    out[..., 2] = _CLAMP[y + _CR_R[cr]]
    return out


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _frame(body: bytes, marker: int, where: str) -> Dict:
    prec, h, w, nf = struct.unpack(">BHHB", body[:6])
    if len(body) < 6 + 3 * nf:
        raise _Corrupt("a truncated frame header")
    if prec != 8:
        raise ValueError(f"{where}: {prec}-bit JPEG: the port reads 8-bit samples only")
    if h == 0:
        raise ValueError(f"{where}: JPEG whose height is in a DNL marker is not read")
    if nf not in (1, 3):
        kind = "4-component (CMYK/YCCK)" if nf == 4 else f"{nf}-component"
        raise ValueError(f"{where}: {kind} JPEG: the port reads grey and 3-component "
                         "colour files only")
    comps = []
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4 for c in comps):
        raise ValueError(f"{where}: bad JPEG sampling factors")
    if nf == 1:  # a single component is its own MCU
        comps[0].update(h=1, v=1)
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    if any(hmax % c["h"] or vmax % c["v"] for c in comps):
        raise ValueError(f"{where}: JPEG sampling factors that are not integer ratios")
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    base = 0
    for c in comps:
        c["dw"] = -(-w * c["h"] // hmax)
        c["dh"] = -(-h * c["v"] // vmax)
        c["bw"], c["bh"] = -(-c["dw"] // 8), -(-c["dh"] // 8)  # blocks holding samples
        c["aw"], c["ah"] = mx * c["h"], my * c["v"]  # blocks allocated (whole MCUs)
        c["base"] = base
        base += c["aw"] * c["ah"] * 64
    return dict(width=w, height=h, comps=comps, hmax=hmax, vmax=vmax, mcus=(mx, my),
                size=base, progressive=marker == 0xC2)


def _scan_blocks(frame, scomps, tables):
    """(coefficient base, component slot, DC table, AC table) of every block
    in the scan's order, and the blocks of one MCU.  A scan of one
    component walks its blocks that hold samples, row by row; a scan of
    several walks whole MCUs, each component's h x v blocks in turn."""
    if len(scomps) == 1:
        comp = frame["comps"][scomps[0]["slot"]]
        rows = np.arange(comp["bh"])[:, None] * comp["aw"] + np.arange(comp["bw"])
        bases, per_mcu = comp["base"] + 64 * rows.ravel(), [(scomps[0]["slot"],) + tables[0]]
    else:
        mx, my = frame["mcus"]
        offsets, per_mcu = [], []
        for c, tabs in zip(scomps, tables):
            comp = frame["comps"][c["slot"]]
            for by in range(comp["v"]):
                for bx in range(comp["h"]):
                    # the block's base in MCU (i, j) is off + 64 * (j * dj + i * di)
                    offsets.append((comp["base"] + 64 * (by * comp["aw"] + bx),
                                    comp["v"] * comp["aw"], comp["h"]))
                    per_mcu.append((c["slot"],) + tabs)
        off, dj, di = (np.array(v)[None, None] for v in zip(*offsets))
        j, i = np.arange(my)[:, None, None], np.arange(mx)[None, :, None]
        bases = (off + 64 * (j * dj + i * di)).ravel()
    slots, dcts, acts = (list(v) * (len(bases) // len(per_mcu)) for v in zip(*per_mcu))
    return list(zip(bases.tolist(), slots, dcts, acts)), len(per_mcu)


def _colour_space(frame, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's default_decompress_parms guess for three components."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c["id"] for c in frame["comps"])
    return "rgb" if ids == (82, 71, 66) else "ycc"


def decode_jpeg(data: bytes, source: Optional[str] = None,
                colour: Optional[str] = None) -> np.ndarray:
    """Decode JPEG bytes as cv2 does with ``IMREAD_UNCHANGED``: (H, W) uint8
    for a grey file, (H, W, 3) uint8 in cv2's BGR order otherwise, the
    EXIF orientation not applied.  ``source`` (a path) names the file in
    the errors.  ``colour`` sets a three-component stream's colour space
    as libtiff sets it for JPEG-in-TIFF: "ycc" converts to RGB, "rgb" keeps
    the components as stored; None guesses as libjpeg does.  A refused
    variant raises ``ValueError`` by name; so does corrupt or truncated
    data, where libjpeg would pad the scan with zeros and cv2 return what
    it decoded."""
    where = _where(source)
    try:
        return _decode(data, where, colour)
    except (_Corrupt, IndexError, OverflowError, struct.error) as err:
        why = f" ({err})" if isinstance(err, _Corrupt) else ""
        raise ValueError(f"{where}: corrupt or truncated JPEG data{why}") from None


def _decode(data: bytes, where: str, colour: Optional[str] = None) -> np.ndarray:
    arr = np.frombuffer(data, np.uint8)
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    frame, coefs, latched = None, None, {}
    restart, jfif, adobe = 0, False, None
    coef_bits = None
    segs = _segments(data, where)
    try:
        marker, start, end = next(segs)
    except StopIteration:
        raise ValueError(f"{where}: JPEG without a frame") from None
    while True:
        body = data[start:end]
        nxt = None
        if marker in (0xC0, 0xC1, 0xC2):
            frame = _frame(body, marker, where)
            coefs = array("i", bytes(4 * frame["size"]))
            coef_bits = [[-1] * 64 for _ in frame["comps"]]
        elif marker in _REFUSED_FRAMES:
            raise ValueError(f"{where}: JPEG with {_REFUSED_FRAMES[marker]}: the port "
                             "reads Huffman-coded baseline, extended and progressive "
                             "8-bit files only")
        elif marker == 0xCC:
            raise ValueError(f"{where}: JPEG with arithmetic coding (DAC marker): the "
                             "port reads Huffman-coded files only")
        elif marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if at + 1 + size > len(body):
                    raise _Corrupt("a truncated quantisation table")
                vals = np.frombuffer(body[at + 1:at + 1 + size], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_NATURAL] = vals
                quant[tq] = q.reshape(8, 8)
                at += 1 + size
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 15
                counts = bytes(body[at + 1:at + 17])
                total = sum(counts)
                if at + 17 + total > len(body):
                    raise _Corrupt("a truncated Huffman table")
                huff[(tc, th)] = (counts, bytes(body[at + 17:at + 17 + total]))
                at += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{where}: JPEG scan before its frame")
            nxt = _scan(arr, body, end, frame, coefs, quant, huff, latched, restart,
                        coef_bits, where)
        try:
            marker, start, end = segs.send(nxt)
        except StopIteration:
            break
    if frame is None:
        raise ValueError(f"{where}: JPEG without a frame")
    return _output(frame, np.frombuffer(coefs, np.int32), latched, coef_bits,
                   colour or _colour_space(frame, jfif, adobe), where)


def _scan(arr, body, end, frame, coefs, quant, huff, latched, restart, coef_bits, where):
    """Decode one scan into ``coefs``; returns the offset after its data."""
    ns = body[0]
    if len(body) < 4 + 2 * ns:
        raise _Corrupt("a truncated scan header")
    scomps = []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        slot = next((j for j, c in enumerate(frame["comps"]) if c["id"] == cid), None)
        if slot is None:
            raise ValueError(f"{where}: JPEG scan of an unknown component {cid}")
        scomps.append(dict(slot=slot, td=t >> 4, ta=t & 15))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    for c in scomps:  # libjpeg latches a component's table at its first scan
        if c["slot"] not in latched:
            tq = frame["comps"][c["slot"]]["tq"]
            if tq not in quant:
                raise ValueError(f"{where}: JPEG quantisation table {tq} is missing")
            latched[c["slot"]] = quant[tq].copy()
    progressive = frame["progressive"]
    dc = ss == 0

    def table(cls, idx, symbols=False):
        if (cls, idx) not in huff:
            raise ValueError(f"{where}: JPEG Huffman table {('DC', 'AC')[cls]}{idx} "
                             "is missing")
        counts, syms = huff[(cls, idx)]
        return _symbol_table(counts, syms) if symbols else \
            _fast_table(counts, syms, cls == 0)

    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
        tables = [(table(0, c["td"]), table(1, c["ta"])) for c in scomps]
    elif dc:
        tables = [(table(0, c["td"]) if ah == 0 else None, None) for c in scomps]
    elif ns == 1:
        tables = [(None, table(1, scomps[0]["ta"], symbols=ah > 0))]
    else:
        raise ValueError(f"{where}: progressive JPEG AC scan of {ns} components")
    blocks, per_mcu = _scan_blocks(frame, scomps, tables)
    per_interval = restart * per_mcu if restart else len(blocks)
    win, starts, stop = _entropy_segment(arr, end)
    n = len(frame["comps"])
    if not progressive:
        _decode_sequential(win, starts, blocks, per_interval, coefs, n)
    elif dc and ah == 0:
        _decode_dc_first(win, starts, blocks, per_interval, coefs, n, al)
    elif dc:
        _decode_dc_refine(win, starts, blocks, per_interval, coefs, al)
    elif ah == 0:
        _decode_ac_first(win, starts, blocks, per_interval, coefs, ss, se, al)
    else:
        _decode_ac_refine(win, starts, blocks, per_interval, coefs, ss, se, al)
    for c in scomps:
        for k in range(ss, se + 1):
            coef_bits[c["slot"]][k] = al
    return stop


def _smoothed(comps, coef_bits, latched) -> bool:
    """``jdcoefct.c:smoothing_ok`` after the whole file: every component's
    table latched with its first ten zigzag entries nonzero, its DC seen,
    and some component with one of AC coefficients 1-9 not refined to
    bit 0 (or never sent)."""
    for slot in range(len(comps)):
        q = latched.get(slot)
        if q is None or not (q.ravel()[_NATURAL[:10]] != 0).all() or coef_bits[slot][0] < 0:
            return False
    return any(b != 0 for bits in coef_bits for b in bits[1:10])


def _output(frame, coefs, latched, coef_bits, colour: str, where) -> np.ndarray:
    comps = frame["comps"]
    if frame["progressive"] and _smoothed(comps, coef_bits, latched):
        raise ValueError(
            f"{where}: progressive JPEG whose first AC coefficients are not fully "
            "refined: libjpeg would smooth its blocks, the port does not")
    h, w = frame["height"], frame["width"]
    planes = []
    for slot, c in enumerate(comps):
        if slot not in latched:
            raise ValueError(f"{where}: JPEG component {c['id']} is in no scan")
        blk = coefs[c["base"]:c["base"] + c["aw"] * c["ah"] * 64]
        blk = blk.reshape(c["ah"], c["aw"], 8, 8)
        px = _idct_islow(blk, latched[slot]).transpose(0, 2, 1, 3)
        plane = px.reshape(c["ah"] * 8, c["aw"] * 8)[:c["dh"], :c["dw"]]
        fh, fv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if fh != 1 or fv != 1:
            plane = _upsample(plane, fh, fv)
        planes.append(plane[:h, :w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if colour == "rgb":
        return np.ascontiguousarray(np.stack(planes[::-1], axis=-1))
    return _ycc_to_bgr(*planes)
