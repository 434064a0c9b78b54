"""Netpbm (PBM/PGM/PPM, ascii and binary), PAM and PFM decoding in numpy,
as cv2 decodes them (``grfmt_pxm.cpp``, ``grfmt_pam.cpp``,
``grfmt_pfm.cpp``).

- ``P1``-``P6``: the header's numbers are digits after any whitespace and
  ``#`` comments (to the end of the line); exactly one byte after the
  last one (the maxval, or the height of a bitmap) ends the header, so a
  ``\\r\\n`` there leaves its ``\\n`` as the first sample byte.  A maxval
  above 255 gives uint16 (two bytes a sample, big-endian).  Binary
  samples are returned raw, whatever the maxval; ascii samples are
  clamped to the maxval, and at 8 bits scaled, ``v * 255 // maxval``.
  Bitmaps give 0 for a set bit and 255 for a clear one.  Colour is BGR.
- ``P7`` (PAM): the header's WIDTH, HEIGHT, DEPTH, MAXVAL and TUPLTYPE
  lines up to ENDHDR; samples raw, in the file's order (cv2 leaves an RGB
  PAM in RGB order).  Without a TUPLTYPE a depth of 1 is grey and 3 RGB
  (maxval below 256).  BLACKANDWHITE tuples raise by name.
- ``Pf`` / ``PF`` (PFM): float32 grey or RGB (returned BGR), rows stored
  bottom-up, little-endian for a negative scale; the samples are
  multiplied by ``float32(1 / |scale|)`` as cv2 does.

``IMREAD_COLOR`` (:func:`decode_color`, RGB) keeps the high byte of 16
bits, replicates grey, and rounds PFM samples half to even, saturated to
0..255 (NaN, infinities and values past the int32 range give 0).  There
cv2 (5.0 and 4.13) returns a PAM with alpha corrupted (it raises by name)
and a one-channel PFM as one channel from bytes (it raises) and as None
from a file (None).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_SPACE = b" \t\n\v\f\r"
_DIGITS = b"0123456789"
_TUPLES = {"GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def matches(data: bytes) -> bool:
    """A PBM/PGM/PPM (``P1``-``P6``), PAM (``P7``) or PFM (``Pf``/``PF``)
    signature followed by whitespace, as cv2's decoders check it."""
    return (len(data) >= 3 and data[0:1] == b"P" and data[1:2] in b"1234567fF"
            and data[2] in _SPACE)


def format_name(data: bytes) -> str:
    kind = data[1:2]
    return "PFM" if kind in b"fF" else "PAM" if kind == b"7" else "PNM"


class _Stream:
    """cv2's ``ReadNumber`` over the header bytes."""

    def __init__(self, data: bytes, at: int, source: Optional[str]):
        self.data, self.at, self.source = data, at, source

    def byte(self) -> int:
        if self.at >= len(self.data):
            raise ValueError(f"{_where(self.source)}: truncated Netpbm file")
        b = self.data[self.at]
        self.at += 1
        return b

    def number(self, maxdigits: int = 0) -> int:
        code = self.byte()
        while code not in _DIGITS:
            if code == ord("#"):
                while code not in b"\n\r":
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{_where(self.source)}: Netpbm: unexpected byte {code} "
                                 "where a number was expected")
        val, digits = 0, 0
        while True:
            val = val * 10 + code - 48
            digits += 1
            if val > 2 ** 31 - 1:
                raise ValueError(f"{_where(self.source)}: Netpbm number too large")
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if code not in _DIGITS:
                break
        return val


def _ascii(stream: _Stream, count: int, maxdigits: int = 0) -> np.ndarray:
    """``count`` ascii numbers (a digit each for a bitmap).  Whitespace
    and comments between them are skipped with numpy when the body is
    plain numbers; cv2's byte loop otherwise."""
    body = stream.data[stream.at:]
    if not maxdigits and b"#" not in body:
        tokens = body.split()
        if len(tokens) >= count and all(t.isdigit() for t in tokens[:count]):
            vals = np.array(tokens[:count]).astype(np.int64)
            if (vals > 2 ** 31 - 1).any():
                raise ValueError(f"{_where(stream.source)}: Netpbm number too large")
            if len(tokens) == count and not body[-1:].isspace():
                raise ValueError(f"{_where(stream.source)}: truncated Netpbm file")
            return vals
    return np.array([stream.number(maxdigits) for _ in range(count)], np.int64)


def _pnm(data: bytes, source: Optional[str]) -> Tuple[np.ndarray, int]:
    """P1-P6 -> (samples (H, W) or (H, W, 3) as cv2's IMREAD_UNCHANGED,
    BGR, file depth 8 or 16)."""
    kind = data[1] - 48
    s = _Stream(data, 2, source)
    w, h = s.number(), s.number()
    maxval = 1 if kind in (1, 4) else s.number()
    if not w or not h or not maxval or maxval > 65535:
        raise ValueError(f"{_where(source)}: Netpbm header {w}x{h}, maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    wide = maxval > 255
    if kind in (1, 4):
        if kind == 4:
            stride = -(-w // 8)
            raw = np.frombuffer(data, np.uint8, stride * h, s.at) if \
                len(data) >= s.at + stride * h else None
            if raw is None:
                raise ValueError(f"{_where(source)}: truncated Netpbm file")
            bits = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w]
        else:
            bits = np.minimum(_ascii(s, w * h, maxdigits=1), 1).reshape(h, w)
        return np.where(bits != 0, 0, 255).astype(np.uint8), 8
    count = w * h * ch
    if kind in (2, 3):
        vals = np.minimum(_ascii(s, count), maxval)
        if not wide:
            vals = vals * 255 // maxval
        img = vals.astype(np.uint16 if wide else np.uint8)
    else:
        dtype = np.dtype(">u2") if wide else np.dtype(np.uint8)
        if len(data) < s.at + count * dtype.itemsize:
            raise ValueError(f"{_where(source)}: truncated Netpbm file")
        img = np.frombuffer(data, dtype, count, s.at).astype(dtype.newbyteorder("="))
    img = img.reshape(h, w, ch)
    return (img[..., 0] if ch == 1 else img[..., ::-1]), 16 if wide else 8


def _pam_header(data: bytes, source: Optional[str]) -> Tuple[Dict, int]:
    fields: Dict = {}
    at = data.find(b"\n") + 1
    while True:
        end = data.find(b"\n", at)
        if end < 0:
            raise ValueError(f"{_where(source)}: PAM header without ENDHDR")
        line = data[at:end].strip()
        at = end + 1
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        if key == b"ENDHDR":
            return fields, at
        fields[key.decode("latin-1")] = value.strip().decode("latin-1")


def _pam(data: bytes, source: Optional[str]) -> Tuple[np.ndarray, int]:
    """P7 -> (samples as stored, (H, W) for one channel; depth 8 or 16)."""
    f, at = _pam_header(data, source)
    try:
        w, h = int(f["WIDTH"]), int(f["HEIGHT"])
        depth, maxval = int(f["DEPTH"]), int(f["MAXVAL"])
    except (KeyError, ValueError):
        raise ValueError(f"{_where(source)}: PAM header without WIDTH, HEIGHT, DEPTH or "
                         "MAXVAL") from None
    tupl = f.get("TUPLTYPE")
    if tupl is None:
        tupl = ({1: "GRAYSCALE", 3: "RGB"}.get(depth) if 1 < maxval < 256
                else "BLACKANDWHITE" if depth == 1 and maxval == 1 else None)
    if tupl and tupl.startswith("BLACKANDWHITE"):
        raise ValueError(f"{_where(source)}: PAM {tupl}: cv2 reads it, the port does not")
    if tupl not in _TUPLES or _TUPLES[tupl] != depth:
        raise ValueError(f"{_where(source)}: PAM of TUPLTYPE {tupl} and DEPTH {depth}")
    if not w or not h or not 0 < maxval < 65536:
        raise ValueError(f"{_where(source)}: PAM header {w}x{h}, maxval {maxval}")
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    count = w * h * depth
    if len(data) < at + count * dtype.itemsize:
        raise ValueError(f"{_where(source)}: truncated PAM file")
    img = np.frombuffer(data, dtype, count, at).astype(dtype.newbyteorder("="))
    img = img.reshape(h, w, depth)
    return (img[..., 0] if depth == 1 else img), 16 if maxval > 255 else 8


def _token(data: bytes, at: int, source: Optional[str]) -> Tuple[str, int]:
    """cv2's PFM ``read_number``: the bytes up to the next whitespace,
    which is consumed."""
    end = at
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data):
        raise ValueError(f"{_where(source)}: truncated PFM header")
    return data[at:end].decode("latin-1"), end + 1


def _pfm(data: bytes, source: Optional[str]) -> np.ndarray:
    """Pf/PF -> float32 (H, W) or BGR (H, W, 3)."""
    if data[2:3] != b"\n":
        raise ValueError(f"{_where(source)}: PFM: a line break expected after the magic")
    ch = 3 if data[1:2] == b"F" else 1
    try:
        tw, at = _token(data, 3, source)
        th, at = _token(data, at, source)
        ts, at = _token(data, at, source)
        w, h, scale = int(tw), int(th), float(ts)
    except ValueError as err:
        raise ValueError(f"{_where(source)}: PFM header: {err}") from None
    if not w or not h or scale == 0.0:
        raise ValueError(f"{_where(source)}: PFM header {w}x{h}, scale {scale}")
    count = w * h * ch
    dtype = np.dtype("<f4" if scale < 0 else ">f4")
    if len(data) < at + 4 * count:
        raise ValueError(f"{_where(source)}: truncated PFM file")
    img = np.frombuffer(data, dtype, count, at).astype(np.float32).reshape(h, w, ch)[::-1]
    if abs(scale) != 1.0:
        img = img * np.float32(1.0 / abs(scale))
    return np.ascontiguousarray(img[..., 0] if ch == 1 else img[..., ::-1])


def decode_unchanged(data: bytes, source: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of Netpbm, PAM or PFM bytes."""
    if data[1:2] in b"fF":
        return _pfm(data, source)
    return (_pam if data[1:2] == b"7" else _pnm)(data, source)[0]


def _saturate8(img: np.ndarray) -> np.ndarray:
    """cv2's float -> uint8: round half to even, saturate; NaN, infinities
    and values outside the int32 range give 0 (x86's integer
    indefinite)."""
    r = np.rint(img.astype(np.float64))
    r = np.where(np.isfinite(r) & (np.abs(r) < 2.0 ** 31), r, 0.0)
    return np.clip(r, 0, 255).astype(np.uint8)


def decode_color(data: bytes, source: Optional[str] = None,
                 from_file: bool = False) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_COLOR)`` then RGB: (H, W, 3) uint8.  A
    one-channel PFM gives None ``from_file`` (``cv2.imread`` refuses the
    one-channel image its decoder returns) and raises from bytes (cv2's
    ``imdecode`` returns it, no RGB image)."""
    kind = data[1:2]
    if kind in b"fF":
        if kind == b"f":
            if from_file:
                return None
            raise ValueError(f"{_where(source)}: a one-channel PFM under IMREAD_COLOR: "
                             "cv2 returns one channel, not an RGB image")
        return _saturate8(_pfm(data, source))[..., ::-1]
    if kind == b"7":
        img, depth = _pam(data, source)
        if img.ndim == 3 and img.shape[-1] in (2, 4):
            raise ValueError(f"{_where(source)}: a PAM with alpha under IMREAD_COLOR: cv2 "
                             "returns it corrupted")
        rgb_slots = img  # cv2 puts the file's first sample where BGR has blue
    else:
        img, depth = _pnm(data, source)
        rgb_slots = img
    if depth == 16:
        rgb_slots = (rgb_slots >> 8).astype(np.uint8)
    if rgb_slots.ndim == 2:
        return np.repeat(rgb_slots[..., None], 3, axis=-1)
    return np.ascontiguousarray(rgb_slots[..., ::-1])
