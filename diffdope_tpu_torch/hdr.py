"""Radiance HDR (RGBE) decoding in numpy, as cv2 reads it (``grfmt_hdr.cpp``
over Bruce Walter's ``rgbe.c``).

The reference reads its images through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:435``, ``mesh.py:1033``).  cv2 takes a file
that starts ``#?RGBE`` or ``#?RADIANCE``:

- the header: lines up to 127 bytes (longer ones are read in pieces) up
  to an empty one, a ``FORMAT=32-bit_rle_rgbe`` line among them, then
  the resolution line, of which only ``-Y <height> +X <width>`` is read
  (``sscanf``'s matching: blanks optional, signs allowed); a file whose
  header fails, whose data ends early or whose runs overrun a scanline
  gives None;
- the pixels: a scanline that starts 2, 2 and its width (8 to 32767
  pixels) is new-style run-length coded, each channel on its own; the
  first one that does not turns the rest of the file into flat RGBE
  pixels, and a width outside 8..32767 reads flat throughout.  Old-style
  runs (1, 1, 1, n) are not expanded: they are pixels too;
- each pixel is ``m * 2**(e - 136)`` (0 where e is 0) in float32, in BGR
  order as cv2 stores the file's R, G, B: ``IMREAD_UNCHANGED`` gives
  (H, W, 3) float32, ``IMREAD_COLOR`` ``convertTo(CV_8U, 255)``: the
  float32 product ``v * 255`` rounded half to even and saturated, a
  product of 2**31 or more (x86's integer indefinite) 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_BLANKS = b" \t\n\v\f\r"


class _NoImage(Exception):
    """Pixels cv2's reader fails on (it gives None)."""


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def matches(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _lines(data: bytes, at: int):
    """``fgets`` with a 128-byte buffer: (line, next offset), a line at
    most 127 bytes and ending after its newline."""
    while at < len(data):
        end = data.find(b"\n", at, at + 127)
        end = min(at + 127, len(data)) if end < 0 else end + 1
        yield data[at:end], end
        at = end


def _scan_size(line: bytes) -> Optional[Tuple[int, int]]:
    """``sscanf(line, "-Y %d +X %d")``: (height, width), None unless both
    are read.  A blank in the format matches any run of blanks, none
    included; ``%d`` skips blanks and takes a sign."""
    at = 0

    def blanks():
        nonlocal at
        while at < len(line) and line[at] in _BLANKS:
            at += 1

    def number() -> Optional[int]:
        nonlocal at
        blanks()
        start = at
        if at < len(line) and line[at] in b"+-":
            at += 1
        digits = at
        while at < len(line) and 48 <= line[at] <= 57:
            at += 1
        return int(line[start:at]) if at > digits else None

    if not line.startswith(b"-Y"):
        return None
    at = 2
    h = number()
    blanks()
    if h is None or line[at:at + 2] != b"+X":
        return None
    at += 2
    w = number()
    return None if w is None else (h, w)


def _header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(height, width, offset of the pixels), None where cv2 reads none."""
    lines = _lines(data, 0)
    next(lines)  # the "#?" line
    has_format = False
    for line, at in lines:
        if line[:1] in (b"", b"\n"):
            break
        has_format |= line == b"FORMAT=32-bit_rle_rgbe\n"
    else:
        return None
    if not has_format or line != b"\n":
        return None
    size = next(lines, None)
    if size is None:
        return None
    found = _scan_size(size[0])
    if found is None:
        return None
    h, w = found
    if h <= 0 or w <= 0:
        return None
    return h, w, size[1]


def _rgbe(data: bytes, h: int, w: int, at: int) -> np.ndarray:
    """The (H, W, 4) RGBE bytes, runs expanded; ``_NoImage`` where the data
    is truncated or a scanline's runs overrun it."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h * w, 4), np.uint8)
    done = 0
    if 8 <= w <= 0x7FFF:
        for _ in range(h):
            head = data[at:at + 4]
            if len(head) < 4:
                break
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break  # not run-length coded: the rest is flat
            if (head[2] << 8 | head[3]) != w:
                raise _NoImage
            at += 4
            row = out[done:done + w]
            for c in range(4):
                x = 0
                while x < w:
                    if at + 2 > len(data):
                        raise _NoImage
                    count = data[at]
                    if count > 128:
                        count -= 128
                        if count > w - x:
                            raise _NoImage
                        row[x:x + count, c] = data[at + 1]
                        at += 2
                    else:
                        if count == 0 or count > w - x or at + 1 + count > len(data):
                            raise _NoImage
                        row[x:x + count, c] = buf[at + 1:at + 1 + count]
                        at += 1 + count
                    x += count
            done += w
    rest = h * w - done
    flat = buf[at:at + 4 * rest]
    if flat.size < 4 * rest:
        raise _NoImage
    out[done:] = flat.reshape(rest, 4)
    return out.reshape(h, w, 4)


def decode_unchanged(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of Radiance HDR bytes: (H,
    W, 3) float32 BGR, or None where cv2 reads no image (a header it
    refuses, truncated data, runs past a scanline)."""
    if not matches(data):
        raise ValueError(f"{_where(source)}: not a Radiance HDR file")
    head = _header(data)
    if head is None:
        return None
    try:
        px = _rgbe(data, *head)
    except _NoImage:
        return None
    e = px[..., 3:].astype(np.int32)
    v = np.ldexp(px[..., 2::-1].astype(np.float32), e - 136)
    return np.where(e > 0, v, np.float32(0)).astype(np.float32)


def decode_color(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of Radiance HDR bytes, then RGB:
    (H, W, 3) uint8, or None where cv2 reads no image."""
    v = decode_unchanged(data, source)
    if v is None:
        return None
    with np.errstate(over="ignore"):
        p = v[..., ::-1] * np.float32(255)
    out = np.clip(np.rint(p), 0, 255)
    return np.where(p >= 2.0 ** 31, 0, out).astype(np.uint8)
