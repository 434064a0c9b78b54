"""GIF decoding in numpy, as cv2 5.0 reads GIF (``grfmt_gif.cpp``).

The reference reads its images through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:435``, ``mesh.py:1033``); cv2 reads the first
frame of a GIF87a or GIF89a file onto its logical screen:

- the screen starts as the global colour table's background colour with
  alpha 0, or black with alpha 0 where the file has no global table;
- the frame's pixels (its local colour table, else the global one, else
  the grey ramp (i, i, i) with 1 white) cover their rectangle with alpha 255, except
  those of the graphic control extension's transparent index, which keep
  the screen's value; an interlaced frame's rows come in the four passes;
- ``IMREAD_UNCHANGED`` gives BGRA where some graphic control extension of
  the file sets a transparent index, else BGR; ``IMREAD_COLOR`` gives BGR;
- a screen of no pixels, a background index past the global table, a
  frame that leaves the screen and a pixel index past its colour table
  give None.

The LZW decoder is the one Python loop (:func:`_lzw_decode`); the
variable-width codes are cut from the bits in numpy, a run of one width
at a time, as ``tiff._lzw_codes`` cuts TIFF's (least significant bit
first here).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")
#: the rows of an interlaced frame in the order they are stored
_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))
#: cv2's colours where the file has no colour table: (i, i, i), but white at 1
_GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
_GREY[1] = 255


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def matches(data: bytes) -> bool:
    return data[:6] in SIGNATURES


def _corrupt(source: Optional[str], why: str):
    raise ValueError(f"{_where(source)}: corrupt or truncated GIF ({why})")


def _sub_blocks(data: bytes, at: int, source: Optional[str]) -> Tuple[bytes, int]:
    """The data sub-blocks from ``at`` on, joined, and the offset after
    their terminator."""
    parts = []
    while True:
        if at >= len(data):
            _corrupt(source, "data sub-blocks past the end of the file")
        n = data[at]
        if n == 0:
            return b"".join(parts), at + 1
        parts.append(data[at + 1:at + 1 + n])
        at += 1 + n


def _codes(win: np.ndarray, pos: int, width: int, n: int) -> List[int]:
    """``n`` codes of ``width`` bits from bit ``pos`` on, least significant
    bit first; ``win`` holds the 32 bits from each byte on."""
    at = pos + width * np.arange(n, dtype=np.int64)
    shift = (at & 7).astype(np.uint32)
    return ((win[at >> 3] >> shift) & ((1 << width) - 1)).tolist()


def _lzw_decode(raw: bytes, min_size: int, size: int, source: Optional[str]) -> bytes:
    """GIF LZW: up to ``size`` bytes of palette indices.  Codes start
    ``min_size`` + 1 bits wide and widen when the next free code reaches
    the width's limit, up to 12 bits, where the table stops growing until
    a Clear; so the codes are cut a run of equal width at a time and the
    string table is the only per-code loop."""
    if not 2 <= min_size <= 11:
        _corrupt(source, f"LZW minimum code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    roots = [bytes((i,)) for i in range(clear)] + [b"", b""]
    buf = np.frombuffer(raw + b"\0\0\0\0", np.uint8).astype(np.uint32)
    win = buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16) | (buf[3:] << 24)
    total = 8 * len(raw)
    out: List[bytes] = []
    produced, pos, width = 0, 0, min_size + 1
    table: List[bytes] = list(roots)
    prev: Optional[bytes] = None
    while produced < size:
        if len(table) < 4096:  # the codes until the table reaches the width's limit
            n = (1 << width) - len(table) + (prev is None)
        else:
            n = 4096
        n = min(n, (total - pos) // width)
        if n <= 0:
            break
        codes = _codes(win, pos, width, n)
        stop = False
        for k, code in enumerate(codes):
            if code == clear:
                pos += (k + 1) * width
                table, prev, width = list(roots), None, min_size + 1
                break
            if code == end:
                stop = True
                break
            if prev is None:
                if code >= clear:
                    _corrupt(source, "an LZW code past the table")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                _corrupt(source, "an LZW code past the table")
            out.append(entry)
            produced += len(entry)
            prev = entry
            if produced >= size:
                stop = True
                break
        else:
            pos += n * width
            if len(table) == 1 << width and width < 12:
                width += 1
            continue
        if stop:
            break
    return b"".join(out)


def decode_gif(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """The first frame of GIF bytes as cv2 gives it with
    ``IMREAD_UNCHANGED``: (H, W, 4) BGRA uint8 where the file sets a
    transparent index, else (H, W, 3) BGR; None where cv2 reads no image.
    ``source`` (a path) names the file in the errors."""
    if not matches(data) or len(data) < 13:
        raise ValueError(f"{_where(source)}: not a GIF file")
    sw, sh, flags, background = struct.unpack("<HHBB", data[6:12])
    at = 13
    palette = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        palette = np.frombuffer(data[at:at + 3 * n], np.uint8)
        if palette.size != 3 * n:
            _corrupt(source, "a global colour table past the end of the file")
        palette = palette.reshape(n, 3)
        at += 3 * n
    transparent: Optional[int] = None
    has_alpha = False
    frame = None
    while at < len(data):
        kind = data[at]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if at + 2 > len(data):
                _corrupt(source, "an extension past the end of the file")
            label = data[at + 1]
            body, nxt = _sub_blocks(data, at + 2, source)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                has_alpha = True
                if frame is None:
                    transparent = body[3]
            at = nxt
        elif kind == 0x2C:
            if at + 10 > len(data):
                _corrupt(source, "an image descriptor past the end of the file")
            left, top, w, h, lflags = struct.unpack("<HHHHB", data[at + 1:at + 10])
            at += 10
            local = None
            if lflags & 0x80:
                n = 2 << (lflags & 7)
                local = np.frombuffer(data[at:at + 3 * n], np.uint8)
                if local.size != 3 * n:
                    _corrupt(source, "a local colour table past the end of the file")
                local = local.reshape(n, 3)
                at += 3 * n
            if at >= len(data):
                _corrupt(source, "image data past the end of the file")
            min_size = data[at]
            raw, at = _sub_blocks(data, at + 1, source)
            if frame is None:
                frame = (left, top, w, h, bool(lflags & 0x40), local, min_size, raw,
                         transparent)
        else:
            _corrupt(source, f"block 0x{kind:02x}")
    if frame is None or not sw or not sh:
        return None
    if palette is not None and background >= len(palette):
        return None
    left, top, w, h, interlaced, local, min_size, raw, transparent = frame
    if left + w > sw or top + h > sh:
        return None
    screen = np.zeros((sh, sw, 4), np.uint8)
    if palette is not None:
        screen[..., :3] = palette[background, ::-1]
    if w and h:
        idx = np.frombuffer(_lzw_decode(raw, min_size, w * h, source), np.uint8)
        if idx.size < w * h:
            _corrupt(source, f"{idx.size} of the frame's {w * h} pixels")
        idx = idx.reshape(h, w)
        if interlaced:
            order = np.concatenate([np.arange(y0, h, dy) for y0, dy in _PASSES])
            rows = np.empty_like(idx)
            rows[order] = idx
            idx = rows
        table = local if local is not None else palette if palette is not None else _GREY
        if int(idx.max()) >= len(table):
            return None
        pixels = np.concatenate([table[idx][..., ::-1], np.full((h, w, 1), 255, np.uint8)],
                                axis=-1)
        region = screen[top:top + h, left:left + w]
        keep = idx != transparent if transparent is not None else np.ones(idx.shape, bool)
        region[keep] = pixels[keep]
    return screen if has_alpha else np.ascontiguousarray(screen[..., :3])
