"""TIFF decoding in numpy and zlib, as cv2 reads TIFF through libtiff.

The reference reads every image through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:1030``, ``mesh.py:417``).  cv2 reads the first
page of a TIFF file along one of two paths, and :func:`decode_unchanged`
and :func:`decode_color` repeat both bit for bit:

- 8-bit results (``IMREAD_COLOR``, and ``IMREAD_UNCHANGED`` of samples of
  8 bits or fewer or of 16-bit grey with alpha) go through libtiff's RGBA
  reader (``tif_getimage.c``): grey keeps the high byte of 16 bits, is
  scaled to 0..255 below 8 bits and inverted for WhiteIsZero, 16-bit RGB
  becomes ``(v + 128) // 257``, a colormap is taken as 8-bit when no
  entry reaches 256 and shifted right by 8 otherwise, signed samples are
  read as unsigned, and an unassociated alpha (ExtraSamples 2)
  premultiplies the colour, ``(c * a + 127) // 255``.
  ``IMREAD_UNCHANGED`` then gives (H, W) for grey (its alpha dropped),
  and for every 1-bit file (a palette's colours made grey by cv2's
  fixed-point weights), BGR for a palette or RGB and BGRA for RGB with an
  extra sample, int8 where the samples are signed.  32- and 64-bit files
  give None here, as cv2 does (the RGBA reader takes none).
- Other ``IMREAD_UNCHANGED`` results (16 to 64-bit integer, float32 and
  float64 files) are the samples as stored: (H, W), BGR or BGRA,
  WhiteIsZero not inverted, 10- to 14-bit samples moved to the top of 16
  bits as cv2 moves them.

JPEG-in-TIFF (compression 7) goes through the RGBA reader too: libtiff
hands each strip or tile to libjpeg after the shared JPEGTables, and the
reader sets ``JPEGCOLORMODE_RGB``, so YCbCr is converted by libjpeg (with
its upsampling) and RGB and grey are taken as coded; ``jpeg.py``
repeats libjpeg-turbo's arithmetic.  A stream whose sampling libtiff
refuses (RGB not at 1x1, a strip sampled otherwise than the first) gives
None, as in cv2.

The orientation tag (274) is applied as cv2 (5.0 and 4.13) applies it in
both modes: the EXIF transform of :func:`orient`, except that on a tiled
file read through the RGBA reader an orientation that flips left-right
(2, 3, 6, 7) reverses the order of the tiles in each row and not the
columns inside a tile (libtiff flips each tile, cv2 the whole row).
``cv2.imread`` of a file whose orientation transposes it (5-8) gives None
in both modes, ``cv2.imdecode`` the transposed image (``from_file``).

Layout: classic TIFF in either byte order, strips or tiles,
PlanarConfiguration 1 or 2, FillOrder 1 or 2, compression none, LZW (new
style), deflate (8 and 32946), PackBits and JPEG (7), predictor 2
(horizontal, per sample at 8 to 64 bits) and 3 (floating point) where
libtiff runs one (LZW and deflate); 1, 4, 8 to 16-bit, 32 and 64-bit
integer samples, signed or not, and 32/64-bit floats; photometric
WhiteIsZero, BlackIsZero, RGB (with or without an extra sample),
palette, and YCbCr inside JPEG.  cv2's header check gives None for 2
bits, 4 bits other than a palette, 16-bit floats and samples of other
formats; libtiff's for several samples below 8 bits, grey with alpha at
32 or 64 bits and a predictor on samples it cannot difference, and so
does the port.  Everything else that cv2 reads raises ``ValueError``
naming the variant and the file: BigTIFF, old-style JPEG and CCITT
compression, the other codecs, old-style LZW, YCbCr outside JPEG, CMYK
and CIE Lab colour, JPEG-in-TIFF in planes or above 8 bits, and, under
``IMREAD_UNCHANGED``, planar samples at 16 bits or more (cv2 reads those
planes as interleaved samples).

LZW is the one Python loop: the code-by-code string table
(:func:`_lzw_decode`); the variable-width codes are cut from the bits in
numpy, one run of a width at a time.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffdope_tpu_torch import jpeg

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")

#: field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4)}
_COMPRESSION = {2: "CCITT modified Huffman RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 32771: "CCITT RLE (word aligned)",
                6: "JPEG (old-style JPEG-in-TIFF)", 7: "JPEG (JPEG-in-TIFF)",
                34712: "JPEG 2000", 50000: "ZSTD", 34925: "LZMA", 50001: "WebP",
                32809: "ThunderScan", 32908: "PixarLog", 32909: "PixarLog"}
_PHOTOMETRIC = {4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr",
                8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL",
                32845: "LogLuv", 32803: "CFA"}
#: bits per sample -> the SampleFormats cv2 reads at that width (1
#: unsigned, 2 signed, 3 IEEE float)
_CV2_FORMATS = {1: (1, 2), 4: (1, 2), 8: (1, 2), 10: (1, 2), 12: (1, 2), 14: (1, 2),
                16: (1, 2), 32: (1, 2, 3), 64: (1, 2, 3)}
#: each byte with its bits in reverse order (FillOrder 2)
_REVERSED = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1]
_REVERSED = np.packbits(_REVERSED, axis=1)[:, 0]
#: LZW: codes read after a Clear at 9, 10 and 11 bits (then 12)
_LZW_RUNS = ((254, 9), (766, 10), (1790, 11))
_LZW_ROOTS = [bytes((i,)) for i in range(256)]
_LZW_CSIZE = 4095 + 1024


class _NoImage(Exception):
    """A file cv2 reads no image from (its decoder fails after the header)."""


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def _refuse(source: Optional[str], variant: str):
    raise ValueError(f"{_where(source)}: TIFF {variant}: cv2 reads it, the port does not")


# ---------------------------------------------------------------------------
# the directory
# ---------------------------------------------------------------------------

def _ifd(data: bytes, source: Optional[str]) -> Tuple[str, Dict[int, list]]:
    """The byte order and the first IFD's fields: tag -> values."""
    if data[:4] in BIGTIFF:
        _refuse(source, "BigTIFF (64-bit offsets)")
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{_where(source)}: not a TIFF file")
    end = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack(end + "I", data[4:8])
    if at + 2 > len(data):
        raise ValueError(f"{_where(source)}: TIFF directory past the end of the file")
    (n,) = struct.unpack(end + "H", data[at:at + 2])
    fields = {}
    for i in range(n):
        entry = data[at + 2 + 12 * i:at + 14 + 12 * i]
        if len(entry) < 12:
            raise ValueError(f"{_where(source)}: truncated TIFF directory")
        tag, kind, count = struct.unpack(end + "HHI", entry[:8])
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * count
        if nbytes <= 4:
            raw = entry[8:8 + nbytes]
        else:
            (off,) = struct.unpack(end + "I", entry[8:12])
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"{_where(source)}: TIFF field {tag} past the end")
        fields[tag] = list(struct.unpack(end + code * count, raw)) if count else []
    return end, fields


def _one(fields, tag: int, default: int) -> int:
    vals = fields.get(tag)
    return int(vals[0]) if vals else default


def _header(data: bytes, source: Optional[str]) -> Dict:
    """The first page's geometry and sample format, every variant the port
    does not decode refused by name."""
    end, f = _ifd(data, source)
    if 256 not in f or 257 not in f:
        raise ValueError(f"{_where(source)}: TIFF without ImageWidth or ImageLength")
    w, h = _one(f, 256, 0), _one(f, 257, 0)
    spp = _one(f, 277, 1)
    bits = f.get(258) or [1]
    if len(set(bits)) != 1:
        _refuse(source, f"with mixed bits per sample {bits}")
    bits = int(bits[0])
    fmt = f.get(339) or [1]
    fmt = int(fmt[0])
    comp = _one(f, 259, 1)
    if 262 not in f:
        raise ValueError(f"{_where(source)}: TIFF without PhotometricInterpretation")
    photo = _one(f, 262, 1)
    planar = _one(f, 284, 1)
    predictor = _one(f, 317, 1)
    if comp not in (1, 5, 7, 8, 32773, 32946):
        _refuse(source, f"compression {comp} ({_COMPRESSION.get(comp, 'unknown')})")
    if photo in _PHOTOMETRIC and not (photo == 6 and comp == 7) or photo not in (0, 1, 2, 3, 6):
        _refuse(source, f"photometric {photo} ({_PHOTOMETRIC.get(photo, 'unknown')})")
    fill = _one(f, 266, 1)
    if fill not in (1, 2):
        raise ValueError(f"{_where(source)}: TIFF FillOrder {fill}")
    # cv2's readHeader: the sample formats it takes at each width; any
    # other width or format, and 4 bits other than a palette's, read as None
    if fmt not in _CV2_FORMATS.get(bits, ()) or (bits == 4 and photo != 3):
        return dict(none=True)
    extra = tuple(int(v) for v in f.get(338, []))
    colours = 3 if photo in (2, 6) else 1
    if spp not in (colours, colours + 1):
        _refuse(source, f"{spp} samples per pixel with photometric {photo}")
    if (bits < 8 and (spp != 1 or photo == 2)) or (bits >= 32 and spp == 2):
        # libtiff's RGBA reader takes one sample below 8 bits; cv2 reads no
        # grey with alpha at 32 or 64 bits
        return dict(none=True)
    if photo == 3 and (spp != 1 or 320 not in f):
        _refuse(source, f"palette at {bits} bits and {spp} samples (or no ColorMap)")
    if planar not in (1, 2):
        raise ValueError(f"{_where(source)}: TIFF PlanarConfiguration {planar}")
    if predictor not in (1, 2, 3):
        _refuse(source, f"predictor {predictor}")
    if comp not in (5, 8, 32946):
        predictor = 1  # libtiff registers the predictor with LZW and deflate only
    if (predictor == 3 and fmt != 3) or (predictor == 2 and bits % 8):
        # libtiff differences 8 to 64-bit samples only, floating point
        # only as floating point
        return dict(none=True)
    tables = b""
    if comp == 7:
        if bits != 8:
            raise ValueError(f"{_where(source)}: TIFF JPEG-in-TIFF at {bits} bits: the port "
                             "reads 8-bit JPEG-in-TIFF only")
        if planar == 2 and spp > 1:
            _refuse(source, "JPEG-in-TIFF with planar configuration 2")
        tables = bytes(f.get(347, []))
    tiled = 322 in f
    if tiled:
        tw, th = _one(f, 322, 0), _one(f, 323, 0)
        offsets, counts = f.get(324), f.get(325)
        if not tw or not th or tw % 16 or th % 16:
            raise ValueError(f"{_where(source)}: TIFF tiles of {tw}x{th}")
    else:
        tw, th = w, min(_one(f, 278, 2 ** 32 - 1), h)
        offsets, counts = f.get(273), f.get(279)
    if not w or not h or not offsets or counts is None:
        raise ValueError(f"{_where(source)}: TIFF without image data")
    cmap = None
    if photo == 3:
        cmap = np.asarray(f[320], np.uint16)
        if cmap.size != 3 << bits:
            raise ValueError(f"{_where(source)}: TIFF ColorMap of {cmap.size} entries")
        cmap = cmap.reshape(3, 1 << bits)
    return dict(end=end, width=w, height=h, spp=spp, bits=bits, format=fmt, compression=comp,
                photometric=photo, planar=planar, predictor=predictor, tiled=tiled,
                block=(tw, th), offsets=offsets, counts=counts, extra=extra, colormap=cmap,
                orientation=_one(f, 274, 1), tables=tables, fill=fill, none=False)


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

def _lzw_codes(win: np.ndarray, pos: int, width: int, n: int) -> List[int]:
    """``n`` codes of ``width`` bits from bit ``pos`` on, most significant
    bit first; ``win`` holds the 32 bits from each byte on."""
    at = pos + width * np.arange(n, dtype=np.int64)
    shift = (32 - width - (at & 7)).astype(np.uint32)
    return ((win[at >> 3] >> shift) & ((1 << width) - 1)).tolist()


def _lzw_decode(raw: bytes, size: int, source: Optional[str]) -> bytes:
    """TIFF LZW (new style, as libtiff's ``LZWDecode``): up to ``size``
    bytes.  After a Clear, 254 codes are 9 bits wide, the next 512 are
    10, the next 1024 11, and the rest 12 (libtiff widens one entry
    early), so the codes are cut a run of equal width at a time and the
    string table is the only per-code loop."""
    if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
        _refuse(source, "old-style LZW (pre-6.0 bit order)")
    buf = np.frombuffer(raw + b"\0\0\0\0", np.uint8).astype(np.uint32)
    win = (buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]
    total = 8 * len(raw)
    out: List[bytes] = []
    produced, pos, since_clear = 0, 0, 0
    table: List[bytes] = _LZW_ROOTS + [b"", b""]
    prev: Optional[bytes] = None
    while produced < size:
        width, run_end = 12, since_clear + 4096
        for end_, w_ in _LZW_RUNS:
            if since_clear < end_:
                width, run_end = w_, end_
                break
        n = min(run_end - since_clear, (total - pos) // width)
        if n <= 0:
            break
        codes = _lzw_codes(win, pos, width, n)
        stop = False
        for k, code in enumerate(codes):
            if code == 256:  # Clear: the table restarts, the widths too
                table, prev = _LZW_ROOTS + [b"", b""], None
                pos += (k + 1) * width
                since_clear = 0
                break
            if code == 257:
                stop = True
                break
            if prev is None:
                if code > 255:
                    raise ValueError(f"{_where(source)}: corrupt TIFF LZW data")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"{_where(source)}: corrupt TIFF LZW data")
            out.append(entry)
            produced += len(entry)
            prev = entry
            if produced >= size:
                stop = True
                break
        else:
            pos += n * width
            since_clear += n
            if len(table) > _LZW_CSIZE:
                raise ValueError(f"{_where(source)}: corrupt TIFF LZW table")
            continue
        if stop:
            break
    return b"".join(out)


def _unpackbits(raw: bytes, size: int) -> bytes:
    """PackBits (libtiff's ``PackBitsDecode``): up to ``size`` bytes."""
    out = bytearray()
    i, n = 0, len(raw)
    while i < n and len(out) < size:
        c = raw[i]
        i += 1
        if c < 128:
            out += raw[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += raw[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, comp: int, size: int, source: Optional[str]) -> bytes:
    if comp == 5:
        data = _lzw_decode(raw, size, source)
    elif comp in (8, 32946):
        try:
            data = zlib.decompressobj().decompress(raw, size)
        except zlib.error as err:
            raise ValueError(f"{_where(source)}: corrupt TIFF deflate data ({err})") from None
    elif comp == 32773:
        data = _unpackbits(raw, size)
    else:
        data = raw
    if len(data) < size:
        raise ValueError(f"{_where(source)}: truncated TIFF data ({len(data)} of {size} "
                         "bytes)")
    return data[:size]


def _dtype(head: Dict) -> np.dtype:
    """The samples' numpy dtype in native byte order (8 bits below 8, 16
    at 10 to 14)."""
    bits = head["bits"]
    return np.dtype("uif"[head["format"] - 1] + str(1 if bits < 8 else -(-bits // 8)))


def _jpeg_block(raw: bytes, head: Dict, rows: int, cols: int,
                source: Optional[str]) -> np.ndarray:
    """A JPEG-in-TIFF strip or tile (rows, cols, spp) as libtiff hands it to
    the RGBA reader: the JPEGTables' quantisation and Huffman tables read
    before an abbreviated stream's own, YCbCr converted to RGB by libjpeg
    (the reader sets ``JPEGCOLORMODE_RGB``) and RGB taken as stored."""
    tables = head["tables"]
    if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8":
        body = tables[2:-2] if tables.endswith(b"\xff\xd9") else tables[2:]
        raw = raw[:2] + body + raw[2:]
    sampling = _jpeg_sampling(raw)
    # libtiff takes the YCbCr subsampling from the first stream and every
    # other component at 1x1; cv2 reads no image where a stream differs
    want = head.setdefault("sampling", sampling[:1] + [(1, 1)] * (len(sampling) - 1)
                           if head["photometric"] == 6 else [(1, 1)] * len(sampling))
    if sampling != want:
        raise _NoImage
    img = jpeg.decode_jpeg(raw, source, colour="ycc" if head["photometric"] == 6 else "rgb")
    spp = head["spp"]
    if img.shape[:2] != (rows, cols) or (img.ndim == 3) != (spp > 1) or \
            (img.ndim == 3 and img.shape[2] != spp):
        raise ValueError(f"{_where(source)}: TIFF JPEG {'tile' if head['tiled'] else 'strip'} "
                         f"of {img.shape} where the directory gives {(rows, cols, spp)}")
    return img[..., None] if img.ndim == 2 else img[..., ::-1]


def _jpeg_sampling(stream: bytes) -> List[Tuple[int, int]]:
    """The (h, v) sampling factors of a JPEG stream's frame components."""
    at = 2
    while at + 4 <= len(stream):
        marker = stream[at + 1]
        (length,) = struct.unpack(">H", stream[at + 2:at + 4])
        if marker in (0xC0, 0xC1, 0xC2):
            n = stream[at + 9]
            return [(stream[at + 11 + 3 * i] >> 4, stream[at + 11 + 3 * i] & 15)
                    for i in range(n)]
        if marker == 0xDA:
            break
        at += 2 + length
    return []


def _block(data: bytes, head: Dict, index: int, rows: int, cols: int, ch: int,
           source: Optional[str]) -> np.ndarray:
    """Strip or tile ``index``: (rows, cols, ch) samples, native order,
    the predictor undone; rows below 8 bits padded to a byte, their
    samples most significant bit first."""
    bits = head["bits"]
    off, count = int(head["offsets"][index]), int(head["counts"][index])
    if head["compression"] == 7:
        return _jpeg_block(data[off:off + count], head, rows, cols, source)
    stride = -(-cols * ch * bits // 8)
    raw = data[off:off + count]
    if head["fill"] == 2:  # libtiff reverses the stored bits before decoding
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    raw = _decompress(raw, head["compression"], rows * stride, source)
    dtype = _dtype(head)
    if bits % 8:
        bit = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(rows, stride), axis=1)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
        bit = bit[:, :cols * ch * bits].reshape(rows, cols * ch, bits)
        vals = (bit * weights).sum(axis=-1, dtype=np.uint16)
        return vals.astype(dtype.str.replace("i", "u")).view(dtype).reshape(rows, cols, ch)
    size = bits // 8
    if head["predictor"] == 3:
        planes = np.frombuffer(raw, np.uint8).reshape(rows, cols * size, ch)
        planes = np.cumsum(planes, axis=1, dtype=np.uint8).reshape(rows, size, cols * ch)
        samples = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(f">f{size}")
        return samples.astype(dtype).reshape(rows, cols, ch)
    samples = np.frombuffer(raw, dtype.newbyteorder(head["end"])).reshape(rows, cols, ch)
    samples = samples.astype(dtype)
    if head["predictor"] == 2:
        ints = samples.view(f"u{size}")
        samples = np.cumsum(ints, axis=1, dtype=ints.dtype).view(dtype)
    return samples


def _samples(data: bytes, head: Dict, source: Optional[str]) -> np.ndarray:
    """The page's samples (H, W, spp) as stored, in native byte order."""
    h, w, spp = head["height"], head["width"], head["spp"]
    bw, bh = head["block"]
    planes = spp if head["planar"] == 2 else 1
    ch = spp // planes
    across, down = (-(-w // bw), -(-h // bh)) if head["tiled"] else (1, -(-h // bh))
    if len(head["offsets"]) < planes * across * down or \
            len(head["counts"]) < planes * across * down:
        raise ValueError(f"{_where(source)}: TIFF with too few strips or tiles")
    out = np.empty((h, w, spp), _dtype(head))
    index = 0
    for plane in range(planes):
        for by in range(down):
            for bx in range(across):
                y0, x0 = by * bh, bx * bw
                rows = bh if head["tiled"] else min(bh, h - y0)
                block = _block(data, head, index, rows, bw, ch, source)
                index += 1
                y1, x1 = min(h, y0 + bh), min(w, x0 + bw)
                out[y0:y1, x0:x1, plane * ch:(plane + 1) * ch] = block[:y1 - y0, :x1 - x0]
    return out


# ---------------------------------------------------------------------------
# cv2's two paths
# ---------------------------------------------------------------------------

def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image as cv2 leaves it for a TIFF or EXIF orientation
    (``ExifTransform`` in ``loadsave.cpp``): 2 flips left-right, 3 turns
    180 degrees, 4 flips top-bottom, 5 transposes, 6, 7 and 8 transpose
    and then flip left-right, both ways or top-bottom; 1 and any other
    value leave it as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _orient_rgba(img: np.ndarray, head: Dict) -> np.ndarray:
    """The orientation on the RGBA reader's result: a tiled file whose
    orientation flips left-right first has its tiles' columns put back in
    order inside each tile (libtiff flipped each tile where cv2 flips the
    row)."""
    o = head["orientation"]
    if head["tiled"] and o in (2, 3, 6, 7):
        tw = head["block"][0]
        flipped = img.copy()
        for x0 in range(0, img.shape[1], tw):
            flipped[:, x0:x0 + tw] = img[:, x0:x0 + tw][:, ::-1]
        img = flipped[:, ::-1]
    return orient(img, o)


def _rgba8(samples: np.ndarray, head: Dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """libtiff's RGBA reader on the samples: (RGB (H, W, 3) uint8, alpha
    (H, W) uint8 or None).  Signed samples are read as unsigned, grey
    below 8 bits scaled to 0..255, and YCbCr is RGB by now (libjpeg's)."""
    photo, bits = head["photometric"], head["bits"]
    samples = samples.view(samples.dtype.str.replace("i", "u"))
    if photo == 3:
        cmap = head["colormap"]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8).T[samples[..., 0]], None
    if photo in (0, 1):
        grey = samples[..., 0]
        if bits == 16:
            grey = (grey >> 8).astype(np.uint8)
        elif bits < 8:
            grey = grey * np.uint8(255 // ((1 << bits) - 1))
        if photo == 0:
            grey = 255 - grey
        return np.repeat(grey[..., None], 3, axis=-1), None
    vals = samples.astype(np.int32)
    if bits == 16:
        vals = (vals + 128) // 257
    rgb, alpha = vals[..., :3], None
    if head["spp"] == 4:
        alpha = vals[..., 3]
        if head["extra"][:1] == (2,):  # unassociated: premultiplied
            rgb = (rgb * alpha[..., None] + 127) // 255
    return rgb.astype(np.uint8), None if alpha is None else alpha.astype(np.uint8)


def _grey(rgb: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_BGRA2Gray_8u_C4C1R`` on the RGBA reader's pixels:
    (R 4899 + G 9617 + B 1868 + 2**13) >> 14."""
    v = rgb.astype(np.int32)
    return ((v[..., 0] * 4899 + v[..., 1] * 9617 + v[..., 2] * 1868 + 8192) >> 14
            ).astype(np.uint8)


def _through_rgba(head: Dict) -> bool:
    """Whether ``IMREAD_UNCHANGED`` takes libtiff's RGBA reader (samples of
    8 bits or fewer, and 16-bit grey with alpha, which cv2 reads as
    8-bit)."""
    return head["bits"] <= 8 or (head["bits"] == 16 and head["photometric"] in (0, 1)
                                 and head["spp"] == 2)


def decode_unchanged(data: bytes, source: Optional[str] = None,
                     from_file: bool = False) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of TIFF bytes: the samples'
    own dtype (8 bits and fewer as uint8 or int8); (H, W) grey, BGR or
    BGRA.  ``from_file`` gives ``cv2.imread``'s result instead, None for
    an orientation that transposes the image (cv2's ``imread`` refuses the
    image its TIFF decoder reallocates).  None where cv2's header check
    refuses the file (2 bits, 4 bits other than a palette, 16-bit float,
    several samples below 8 bits)."""
    head = _header(data, source)
    if head["none"] or from_file and head["orientation"] in (5, 6, 7, 8):
        return None
    try:
        samples = _samples(data, head, source)
    except _NoImage:
        return None
    if _through_rgba(head):
        rgb, alpha = _rgba8(samples, head)
        if head["bits"] == 1:  # cv2 reads one channel at 1 bit, a palette's as grey
            img = _grey(rgb)
        elif head["photometric"] in (0, 1):
            img = rgb[..., 0]
        elif alpha is not None:
            img = np.concatenate([rgb[..., ::-1], alpha[..., None]], axis=-1)
        else:
            img = rgb[..., ::-1]
        if head["format"] == 2:
            img = img.view(np.int8)
        return _orient_rgba(img, head)
    if head["planar"] == 2 and head["spp"] > 1:
        _refuse(source, f"planar configuration 2 at {head['bits']} bits under "
                "IMREAD_UNCHANGED (cv2 reads the planes as interleaved samples)")
    if head["bits"] in (10, 12, 14):  # cv2 moves the samples to the top bits
        samples = (samples.view(np.uint16) << (16 - head["bits"])).view(samples.dtype)
    if head["spp"] == 1:
        img = samples[..., 0]
    else:
        img = samples[..., [2, 1, 0, 3][:head["spp"]]]
    return orient(img, head["orientation"])


def decode_color(data: bytes, source: Optional[str] = None,
                 from_file: bool = False) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of TIFF bytes, then RGB: (H, W,
    3) uint8, or None for 32- and 64-bit samples (libtiff's RGBA reader
    takes none), as cv2 gives (and, with ``from_file``, for an orientation
    that transposes the image, as ``cv2.imread`` gives)."""
    head = _header(data, source)
    if head["none"] or head["bits"] not in (1, 4, 8, 16) or \
            (from_file and head["orientation"] in (5, 6, 7, 8)):
        return None
    try:
        rgb, _ = _rgba8(_samples(data, head, source), head)
    except _NoImage:
        return None
    return _orient_rgba(rgb, head)
