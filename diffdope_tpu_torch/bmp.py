"""BMP decoding in numpy, as cv2 decodes it (``grfmt_bmp.cpp``).

- Headers of 12 bytes (OS/2: 16-bit sizes, 3-byte palette entries), 40,
  108 and 124 bytes; bottom-up rows, or top-down for a negative height;
  rows padded to 4 bytes.
- 1-, 4- and 8-bit palettes (``colors used`` entries, the rest black),
  RLE8 and RLE4 (runs, absolute blocks, end of line, delta and end of
  bitmap; what the escapes skip takes palette entry 0, as cv2 fills it),
  16 bits as 5-5-5 (BI_RGB, or BI_BITFIELDS with those masks) or 5-6-5
  (BI_BITFIELDS) expanded by a shift left (no bit replication), 24-bit
  BGR and 32-bit BGRX/BGRA.
- ``IMREAD_UNCHANGED`` gives (H, W) grey where cv2 does: a palette whose
  2**bits entries are all grey, and anything under the 12-byte header
  (cv2 never marks those colour); grey from colour is cv2's
  ``(b * 1868 + g * 9617 + r * 4899 + 8192) >> 14``.  32 bits give BGR
  for BI_RGB and BGRA for BI_BITFIELDS: under a header of 56 bytes or more
  each channel is ``(v & mask) >> shift`` of its mask (alpha 255 without
  an alpha mask), under a 40-byte one the bytes as stored.
- ``IMREAD_COLOR`` (:func:`decode_color`, RGB) expands every palette and
  takes the first three channels of a 32-bit pixel as above.

16-bit BI_BITFIELDS masks other than 5-5-5 and 5-6-5, and masks read past
a header of 56 bytes or more (cv2 reads them after the header), raise, as
cv2 reads none of them; so does RLE that runs past its row.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

SIGNATURE = b"BM"
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def _grey(bgr: np.ndarray) -> np.ndarray:
    """cv2's BGR -> grey (``icvCvt_BGR2Gray_8u_C3C1R``)."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)


def _header(data: bytes, source: Optional[str]) -> Dict:
    if len(data) < 18 or not data.startswith(SIGNATURE):
        raise ValueError(f"{_where(source)}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    head = dict(offset=offset, masks=None, colour=True)
    at = 14 + size
    if size == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        comp, n_pal, entry = _RGB, 1 << bits if bits <= 8 else 0, 3
        head["colour"] = False
        if bits not in (1, 4, 8, 24, 32):
            raise ValueError(f"{_where(source)}: BMP of {bits} bits under the 12-byte header")
    elif size >= 36:
        w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        (clrused,) = struct.unpack("<I", data[46:50])
        entry = 4
        ok = ((bits in (1, 4, 8, 16, 24, 32) and comp == _RGB)
              or (bits in (16, 32) and comp == _BITFIELDS)
              or (bits == 4 and comp == _RLE4) or (bits == 8 and comp == _RLE8))
        if not ok:
            raise ValueError(f"{_where(source)}: BMP of {bits} bits and compression "
                             f"{comp}: cv2 reads no such file")
        if bits <= 8:
            if clrused > 256:
                raise ValueError(f"{_where(source)}: BMP palette of {clrused} entries")
            n_pal = clrused or 1 << bits
        else:
            n_pal = 0
        if bits == 32 and comp == _BITFIELDS and size >= 56:
            head["masks"] = struct.unpack("<4I", data[54:70])
        elif bits == 16 and comp == _BITFIELDS:
            masks = struct.unpack("<3I", data[at:at + 12])
            if masks == (0x7C00, 0x3E0, 0x1F):
                bits = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise ValueError(f"{_where(source)}: BMP 16-bit masks "
                                 f"{[hex(m) for m in masks]}: cv2 reads 5-5-5 and 5-6-5 only")
        elif bits == 16:
            bits = 15
    else:
        raise ValueError(f"{_where(source)}: BMP info header of {size} bytes")
    if w <= 0 or h == 0:
        raise ValueError(f"{_where(source)}: BMP of {w}x{h}")
    palette = np.zeros((256, 3), np.uint8)  # BGR
    if bits <= 8:
        raw = data[at:at + n_pal * entry]
        if len(raw) < n_pal * entry:
            raise ValueError(f"{_where(source)}: truncated BMP palette")
        palette[:n_pal] = np.frombuffer(raw, np.uint8).reshape(n_pal, entry)[:, :3]
        if size != 12:
            used = palette[: 1 << bits]
            head["colour"] = bool(((used[:, 0] != used[:, 1])
                                   | (used[:, 0] != used[:, 2])).any())
    head.update(width=w, height=abs(h), top_down=h < 0, bits=bits, comp=comp,
                palette=palette)
    return head


def _rle(data: bytes, head: Dict, source: Optional[str]) -> np.ndarray:
    """RLE8 / RLE4 -> palette indices (H, W) in stored row order, skipped
    pixels at index 0 (cv2's fill with palette entry 0).  A run or
    absolute block must end inside its row; an RLE8 run that ends on the
    row's last pixel moves to the next row at once (and an end of line
    right after it does nothing), an RLE4 one stays at the row's end."""
    w, h = head["width"], head["height"]
    four = head["comp"] == _RLE4
    out = np.zeros((h, w), np.uint8)
    at, n = head["offset"], len(data)
    y = x = 0
    wrapped = False  # RLE8: the last run ended its row

    def bad():
        raise ValueError(f"{_where(source)}: corrupt BMP RLE data")

    def skip(count: int):
        """cv2's FillUniColor with entry 0: ``count`` pixels on, wrapping
        rows, and to the next row when it ends on a row's end."""
        nonlocal x, y
        while True:
            step = min(count, w - x)
            count -= step
            x += step
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if count <= 0:
                return

    while y < h:
        if at + 2 > n:
            bad()
        length, code = data[at], data[at + 1]
        at += 2
        if length:
            if x + length > w:
                bad()
            if four:
                pair = np.array([code >> 4, code & 15], np.uint8)
                out[y, x:x + length] = np.resize(pair, length)
            else:
                out[y, x:x + length] = code
            x += length
            wrapped = False
            if x == w and not four:
                x, y, wrapped = 0, y + 1, True
        elif code > 2:  # absolute block, padded to 16 bits
            if x + code > w:
                bad()
            nbytes = ((code + 1) // 2 if four else code)
            raw = np.frombuffer(data, np.uint8, nbytes, at) if at + nbytes <= n else bad()
            at += nbytes + (nbytes & 1)
            if four:
                raw = np.stack([raw >> 4, raw & 15], axis=1).reshape(-1)
            out[y, x:x + code] = raw[:code]
            x += code
            wrapped = False
        elif code == 0:  # end of line
            if not (wrapped and x == 0):
                skip(w - x)
            wrapped = False
        elif code == 1:  # end of bitmap
            break
        else:  # delta
            if at + 2 > n:
                bad()
            dx, dy = data[at], data[at + 1]
            at += 2
            skip(dx + dy * w)
            wrapped = False
    return out


def _pixels(data: bytes, head: Dict, source: Optional[str]):
    """(kind, array) in stored row order: ('index', (H, W)), ('bgr',
    (H, W, 3)) or ('bgrx', (H, W, 4) the bytes as stored)."""
    w, h, bits = head["width"], head["height"], head["bits"]
    if head["comp"] in (_RLE8, _RLE4):
        return "index", _rle(data, head, source)
    stride = (w * (16 if bits == 15 else bits) + 31) // 32 * 4
    off = head["offset"]
    if len(data) < off + stride * h:
        raise ValueError(f"{_where(source)}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
    if bits == 8:
        return "index", rows[:, :w]
    if bits < 8:
        bitsarr = np.unpackbits(rows, axis=1)[:, : w * bits].reshape(h, w, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        return "index", (bitsarr * weights).sum(axis=-1, dtype=np.uint8)
    if bits in (15, 16):
        t = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        if bits == 15:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], axis=-1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], axis=-1)
        return "bgr", bgr.astype(np.uint8)
    if bits == 24:
        return "bgr", rows[:, : 3 * w].reshape(h, w, 3)
    return "bgrx", rows[:, : 4 * w].reshape(h, w, 4)


def _unmasked(px: np.ndarray, head: Dict) -> np.ndarray:
    """32-bit BI_BITFIELDS pixels as cv2 gives them, BGRA: under a header
    of 56 bytes or more each channel ``(v & mask) >> shift`` of its mask
    (alpha 255 without an alpha mask), the bytes as stored otherwise or
    where a colour mask is 0."""
    masks = head["masks"]
    if masks is None or not all(masks[:3]):
        return px
    v = px.copy().view("<u4")[..., 0].astype(np.int64)
    shifts = [((m & -m).bit_length() - 1) if m else 0 for m in masks]
    chans = [((v & m) >> s) & 255 for m, s in zip(masks, shifts)]
    alpha = chans[3] if masks[3] else np.full_like(v, 255)
    return np.stack([chans[2], chans[1], chans[0], alpha], axis=-1).astype(np.uint8)


def _upright(img: np.ndarray, head: Dict) -> np.ndarray:
    return np.ascontiguousarray(img if head["top_down"] else img[::-1])


def decode_unchanged(data: bytes, source: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of BMP bytes: uint8 (H, W)
    grey, (H, W, 3) BGR or (H, W, 4) BGRA."""
    head = _header(data, source)
    kind, px = _pixels(data, head, source)
    if kind == "index":
        if not head["colour"]:  # cv2's grey palette, then the indices through it
            return _upright(_grey(head["palette"])[px], head)
        bgr = head["palette"][px]
    elif kind == "bgr":
        bgr = px
    else:
        bgr = px[..., :3]
        if head["colour"] and head["comp"] == _BITFIELDS:
            return _upright(_unmasked(px, head), head)
    if not head["colour"]:
        return _upright(_grey(bgr), head)
    return _upright(bgr, head)


def decode_color(data: bytes, source: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of BMP bytes, then RGB."""
    head = _header(data, source)
    kind, px = _pixels(data, head, source)
    if kind == "index":
        bgr = head["palette"][px]
    elif kind == "bgrx" and head["comp"] == _BITFIELDS:
        bgr = _unmasked(px, head)[..., :3]
    else:
        bgr = px[..., :3]
    return _upright(bgr[..., ::-1], head)
