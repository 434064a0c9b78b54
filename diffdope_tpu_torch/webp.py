"""WebP decoding in numpy, as libwebp decodes for cv2.

The reference reads every image through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:1033``, ``mesh.py:435``), and cv2 reads WebP
through libwebp's default decode, which is integer arithmetic throughout.
:func:`decode_webp` repeats it and so returns cv2's arrays bit for bit:
BGR, or BGRA when the file's first 32 bytes say it has alpha (cv2 asks
``WebPGetFeatures`` about that many), and the EXIF orientation, which
``png.py`` applies under ``IMREAD_COLOR`` as cv2 (4.13 and 5.0) does.

- The RIFF container (RFC 9649 2): the simple ``VP8 `` and ``VP8L``
  files, and ``VP8X`` with ``ALPH``, ``ICCP``, ``EXIF``, ``XMP `` and
  unknown chunks; chunk padding; libwebp's checks of the sizes, which
  make cv2 return None (a RIFF size past the file, a chunk past the RIFF
  size, a canvas that is not the frame's).  An animation reads as cv2
  reads it: its first frame on a transparent black canvas.
- Lossless (``VP8L``, RFC 9649 3-5): the four transforms, undone in
  reverse order (the predictor along the lines 2y + x = constant, so a
  step is one vectorised update; the colour transform, subtract-green,
  colour indexing with pixels bundled at 1, 2, 4 or 8 bits); simple and
  normal prefix codes; LZ77 with the 120-entry distance map; the colour
  cache; meta prefix codes.  The symbol decode is the one Python loop
  (:func:`_vp8l_pixels`).
- Lossy (``VP8 `` key frames, RFC 6386): the boolean decoder, the frame
  header (segments and their map, the loop filter's level, the quantizer
  indices and deltas, the coefficient probability updates), the DC and
  AC quantizer tables, the WHT and the DCT (a block libwebp hands its
  SSE2 transform in 16-bit lanes, :func:`_idct`), intra prediction (the 16x16
  and chroma modes, the ten 4x4 modes with the above-right rule) along
  the macroblock wavefront 2y + x = constant, the normal loop filter with
  the inner-edge skip, one numpy update per edge across each wavefront,
  cropping, and YUV 4:2:0 to BGR by libwebp's fancy upsampler and its
  14-bit fixed point (:func:`_yuv_to_bgr`).  The token decode is the other
  Python loop (:func:`_vp8_tokens`).
- Alpha (``ALPH``, RFC 9649 2.7): raw or VP8L-coded, the horizontal,
  vertical and gradient filters undone.

What no writer of the corpus in ``tests/torch_data/webp/`` reaches raises
``ValueError`` naming the feature and the file: the simple loop filter, a
sharpness above 0, loop-filter deltas, more than one token partition,
segment values relative to the frame's, a segment map kept from a frame
before, and the lossless predictor modes 14 and 15.  A file cv2 returns
None for (truncated, or a bitstream libwebp rejects) gives None.

The constant tables below are transcribed from a compiled libwebp by
``tools/port_webp_tables.py``, which a test holds them to.
"""

from __future__ import annotations

import struct
from array import array
from typing import List, Optional, Tuple

import numpy as np

SIGNATURE = b"RIFF"

_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
)

_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
)

_COEFFS_PROBA0 = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
)

_COEFFS_UPDATE_PROBA = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
)

_BMODES_PROBA = (
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179,
    64, 126, 170, 118, 46, 70, 95, 175, 69, 143, 80,
    85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189,
    17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10,
    173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144,
    71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55,
    19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114,
    208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29,
    16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102,
    167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178,
    241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166,
    49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115,
    128, 104, 79, 12, 27, 217, 255, 87, 17, 7, 87,
    68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14,
    110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197,
    189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45,
    196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34,
    51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171,
    58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34,
    43, 166, 73, 107, 54, 32, 26, 51, 1, 81, 43,
    31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34,
    19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78,
    95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215,
    111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21,
    18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43,
    29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155,
    67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1,
    51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197,
    171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51,
    50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36,
    171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82,
    115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93,
    73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17,
    33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24,
    128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128,
    23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6,
    223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104,
    55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70,
    205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5,
    41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10,
    32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32,
    12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67,
    102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205,
    45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34,
    98, 125, 98, 42, 88, 104, 85, 117, 175, 82, 95,
    84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123,
    47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102,
    57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26,
    1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29,
    16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102,
    102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128,
    68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243,
    192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68,
    45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19,
    70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100,
    163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32,
    201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8,
    17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82,
    135, 57, 26, 121, 40, 164, 50, 31, 137, 154, 133,
    25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6,
    158, 86, 40, 64, 135, 148, 224, 45, 183, 128, 22,
    26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21,
    91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60,
    138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68,
    47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27,
    10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99,
    180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51,
    41, 20, 32, 101, 75, 128, 139, 118, 146, 116, 128,
    85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71,
    30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60,
    138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171,
    255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81,
    188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
)

_ZIGZAG = (
    0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15,
)

_BANDS = (
    0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
    0,
)

_CAT3 = (
    173, 148, 140, 0,
)

_CAT4 = (
    176, 155, 140, 135, 0,
)

_CAT5 = (
    180, 157, 141, 134, 130, 0,
)

_CAT6 = (
    254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0,
)

_CODE_LENGTH_ORDER = (
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15,
)

_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
)



def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


class _Fail(Exception):
    """A file libwebp refuses: cv2 returns None for it."""


class _Unsupported(Exception):
    """A feature cv2 reads and the port refuses (its name)."""


def matches(data: bytes) -> bool:
    """A RIFF file of form WEBP (cv2's signature test)."""
    return data[:4] == SIGNATURE and data[8:12] == b"WEBP"


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

_MAX_CHUNK = (1 << 32) - 1 - 8 - 1
_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02


def _le24(b: bytes) -> int:
    return b[0] | b[1] << 8 | b[2] << 16


def _vp8_info(body: bytes, chunk_size: int) -> Tuple[int, int]:
    """``VP8GetInfo``: the frame's (width, height), checked as libwebp
    checks a key frame's first ten bytes."""
    if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
        raise _Fail
    bits = _le24(body)
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise _Fail
    w, h = struct.unpack("<HH", body[6:10])
    if not w & 0x3FFF or not h & 0x3FFF:
        raise _Fail
    return w & 0x3FFF, h & 0x3FFF


def _vp8l_info(body: bytes) -> Tuple[int, int, int]:
    """``VP8LGetInfo``: (width, height, the alpha hint)."""
    if len(body) < 5 or body[0] != 0x2F or body[4] >> 5:
        raise _Fail
    (bits,) = struct.unpack("<I", body[1:5])
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _features(head: bytes) -> bool:
    """``WebPGetFeatures`` on the file's first 32 bytes, as cv2 calls it:
    whether the image has alpha; ``_Fail`` where it fails."""
    riff_size = struct.unpack("<I", head[4:8])[0]
    if riff_size < 12 or riff_size > _MAX_CHUNK:
        raise _Fail
    kind, size = head[12:16], struct.unpack("<I", head[16:20])[0]
    if kind == b"VP8X":
        if size != 10:
            raise _Fail
        flags = struct.unpack("<I", head[20:24])[0]
        return bool(flags & _ALPHA_FLAG)
    if kind not in (b"VP8 ", b"VP8L") or size > riff_size - 12:
        raise _Fail
    if kind == b"VP8 ":
        _vp8_info(head[20:], size)
        return False
    return bool(_vp8l_info(head[20:])[2])


def _chunks(data: bytes, at: int, end: int, riff_size: int):
    """(fourcc, body start, body size) of the chunks from ``at`` on, each
    checked against the RIFF size and the data (``ParseOptionalChunks``);
    the walk stops at the image chunk, whose body may run past the data."""
    total = 4 + 8 + 10
    while True:
        if end - at < 8:
            raise _Fail
        kind, size = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
        if size > _MAX_CHUNK:
            raise _Fail
        disk = (8 + size + 1) & ~1
        total += disk
        if total > riff_size:
            raise _Fail
        yield kind, at + 8, size
        if kind in (b"VP8 ", b"VP8L"):
            return
        if end - at < disk:
            raise _Fail
        at += disk


def _exif_chunk(data: bytes, riff_size: int) -> bytes:
    """The body of a VP8X file's EXIF chunk, wherever it lies (writers put
    it after the image), or b""."""
    at, end = 30, min(len(data), riff_size + 8)
    while at + 8 <= end:
        kind, size = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
        if kind == b"EXIF":
            return data[at + 8:at + 8 + size]
        at += (8 + size + 1) & ~1
    return b""


def _still(kind: bytes, body: bytes, chunk_size: int, alpha: Optional[bytes], size
           ) -> np.ndarray:
    """A VP8 or VP8L chunk's image (``body`` runs from the chunk's body to
    the end of what libwebp was handed) -> BGRA uint8, a VP8 frame's alpha
    from its ALPH chunk (opaque without one); ``size`` is the (width,
    height) the container declares, or None."""
    if kind == b"VP8L":
        w, h, _ = _vp8l_info(body)
        if size is not None and size != (w, h):
            raise _Fail
        return _vp8l_decode(body, w, h).view(np.uint8).reshape(h, w, 4)
    w, h = _vp8_info(body, chunk_size)
    if size is not None and size != (w, h):
        raise _Fail
    a = np.full((h, w), 255, np.uint8) if alpha is None else _alpha(alpha, w, h)
    return np.concatenate([_vp8_decode(body, w, h), a[..., None]], axis=-1)


def _image(data: bytes, at: int, riff_size: int, canvas) -> np.ndarray:
    """The still image from the chunk at ``at`` (past a VP8X chunk when
    ``canvas`` is given: its optional chunks, an ALPH among them, then the
    image) -> BGRA uint8, with libwebp's size checks."""
    alpha = None
    if canvas is not None:
        for kind, start, size in _chunks(data, at, len(data), riff_size):
            if kind == b"ALPH":
                alpha = data[start:start + size]
            at = start - 8
    kind, size = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
    if kind not in (b"VP8 ", b"VP8L") or size > riff_size - 12 or size > len(data) - at - 8:
        raise _Fail
    # libwebp hands the decoder everything from the chunk's body to the end
    return _still(kind, data[at + 8:], size, alpha, canvas)


def _animation(data: bytes, riff_size: int, canvas) -> np.ndarray:
    """cv2's read of an animation: its first frame decoded onto a
    transparent black canvas (``WebPAnimDecoder`` clears a key frame's
    canvas and decodes the frame into it unblended)."""
    cw, ch = canvas
    for kind, start, size in _chunks(data, 30, len(data), riff_size):
        if kind == b"ANMF":
            if size < 16 + 8 or start + size > len(data):
                raise _Fail
            head = data[start:start + 16]
            x0, y0 = 2 * _le24(head[0:3]), 2 * _le24(head[3:6])
            fw, fh = _le24(head[6:9]) + 1, _le24(head[9:12]) + 1
            if x0 + fw > cw or y0 + fh > ch:
                raise _Fail
            out = np.zeros((ch, cw, 4), np.uint8)
            out[y0:y0 + fh, x0:x0 + fw] = _frame(data[start + 16:start + size], (fw, fh))
            return out
        if kind in (b"VP8 ", b"VP8L"):
            raise _Fail
    raise _Fail


def _frame(frame: bytes, size) -> np.ndarray:
    """An ANMF frame's image (its ALPH, VP8 or VP8L sub-chunks) -> BGRA."""
    alpha, at = None, 0
    while at + 8 <= len(frame):
        kind, n = frame[at:at + 4], struct.unpack("<I", frame[at + 4:at + 8])[0]
        if kind in (b"VP8 ", b"VP8L"):
            if len(frame) - at - 8 < n:
                raise _Fail
            return _still(kind, frame[at + 8:at + 8 + n], n, alpha, size)
        if kind == b"ALPH":
            alpha = frame[at + 8:at + 8 + n]
        at += (8 + n + 1) & ~1
    raise _Fail


def decode_webp(data: bytes, source: Optional[str] = None
                ) -> Optional[Tuple[np.ndarray, bytes]]:
    """Decode WebP bytes as ``cv2.imdecode``/``cv2.imread`` with
    ``IMREAD_UNCHANGED`` do -> (image, exif), or None where cv2 gives None.

    The image is (H, W, 4) BGRA uint8 when the first 32 bytes say the
    file has alpha (a VP8X alpha flag, a VP8L alpha hint), else (H, W, 3)
    BGR; ``exif`` is the EXIF chunk's body (b"" without one), whose
    orientation cv2 applies under ``IMREAD_COLOR``.  ``source`` (a path)
    names the file in the errors."""
    if not matches(data):
        raise ValueError(f"{_where(source)}: not a WebP file")
    if len(data) < 32:  # cv2's WEBP_HEADER_SIZE
        return None
    try:
        has_alpha = _features(data[:32])
        riff_size = struct.unpack("<I", data[4:8])[0]
        if riff_size > len(data) - 8:
            return None
        exif = b""
        if data[12:16] == b"VP8X":
            flags = struct.unpack("<I", data[20:24])[0]
            canvas = (_le24(data[24:27]) + 1, _le24(data[27:30]) + 1)
            if flags & _ANIMATION_FLAG:
                img = _animation(data, riff_size, canvas)
            else:
                img = _image(data, 30, riff_size, canvas)
                exif = _exif_chunk(data, riff_size)
        else:
            img = _image(data, 12, riff_size, None)
    except _Fail:
        return None
    except _Unsupported as err:
        raise ValueError(f"{_where(source)}: WebP {err}: cv2 reads it, the port does not")
    return (img if has_alpha else np.ascontiguousarray(img[..., :3])), exif


# ---------------------------------------------------------------------------
# lossless: VP8L
# ---------------------------------------------------------------------------

#: alphabet sizes of a group's five codes: green + length prefixes, red,
#: blue, alpha, distance prefixes
_ALPHABETS = (256 + 24, 256, 256, 256, 40)


class _LBits:
    """VP8L's bit reader (least significant bit first) over 64-bit words
    that start every 4 bytes, so any 32 bits at any position are one list
    index and a shift; ``end`` is the stream's length in bits."""

    __slots__ = ("win", "pos", "end")

    def __init__(self, data: bytes):
        pad = bytes(data) + bytes(16 + (-len(data)) % 4)
        words = np.frombuffer(pad, "<u4").astype(np.uint64)
        self.win = (words[:-1] | (words[1:] << np.uint64(32))).tolist()
        self.pos = 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.win[p >> 5] >> (p & 31)) & ((1 << n) - 1)


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _huffman(lengths) -> Tuple[List[int], int]:
    """A canonical prefix code's lookup table (``VP8LBuildHuffmanTable``):
    (entries, index mask); an entry is length << 16 | symbol, indexed by
    the next bits in stream order.  A code of one symbol takes no bits;
    any other code must be complete."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if used.size == 0:
        raise _Fail
    if used.size == 1:
        return [int(used[0])], 0
    lens = lengths[used]
    if int((1 << (15 - lens)).sum()) != 1 << 15:
        raise _Fail
    order = np.lexsort((used, lens))
    syms, lens = used[order].tolist(), lens[order].tolist()
    top = lens[-1]
    table = np.zeros(1 << top, np.int64)
    code, prev = -1, lens[0]
    for sym, n in zip(syms, lens):
        code = (code + 1) << (n - prev)
        prev = n
        rev = int(format(code, f"0{n}b")[::-1], 2)
        table[rev::1 << n] = n << 16 | sym
    return table.tolist(), (1 << top) - 1


def _read_code(br: _LBits, alphabet: int) -> Tuple[List[int], int]:
    """One prefix code (RFC 9649 3.7.2.1): simple, or normal through the
    code-length code."""
    lengths = [0] * alphabet
    if br.read(1):
        count = br.read(1) + 1
        for k in range(count):  # the first symbol takes 1 or 8 bits, the second 8
            sym = br.read(8 if (k == 1 or br.read(1)) else 1)
            if sym < alphabet:
                lengths[sym] = 1
    else:
        clens = [0] * 19
        for i in range(br.read(4) + 4):
            clens[_CODE_LENGTH_ORDER[i]] = br.read(3)
        table, mask = _huffman(clens)
        if br.read(1):
            limit = 2 + br.read(2 + 2 * br.read(3))
            if limit > alphabet:
                raise _Fail
        else:
            limit = alphabet
        sym, prev = 0, 8
        win = br.win
        while sym < alphabet and limit:
            limit -= 1
            p = br.pos
            e = table[(win[p >> 5] >> (p & 31)) & mask]
            br.pos = p + (e >> 16)
            n = e & 0xFFFF
            if n < 16:
                lengths[sym] = n
                sym += 1
                if n:
                    prev = n
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
                repeat = br.read(extra) + offset
                if sym + repeat > alphabet:
                    raise _Fail
                lengths[sym:sym + repeat] = [prev if n == 16 else 0] * repeat
                sym += repeat
    if br.pos > br.end:
        raise _Fail
    return _huffman(lengths)


def _plane_distances(width: int) -> List[int]:
    """The distance of each of the 120 short codes at this width
    (``PlaneCodeToDistance``)."""
    out = []
    for code in _CODE_TO_PLANE:
        dist = (code >> 4) * width + 8 - (code & 0xF)
        out.append(dist if dist >= 1 else 1)
    return out


def _vp8l_pixels(br: _LBits, w: int, h: int, groups, meta: Optional[List[int]],
                 meta_bits: int, cache_bits: int) -> List[int]:
    """The entropy-coded image (RFC 9649 5.2): literals, LZ77 copies and
    colour-cache hits -> w * h packed ARGB values.  The cache is brought
    up to date only where it is read, as libwebp does."""
    n = w * h
    px = [0] * n
    win, p = br.win, br.pos
    plane = _plane_distances(w)
    tabs = [tuple(x for code in g for x in code) for g in groups]
    tg, mg, tr, mr, tb, mb, ta, ma, td, md = tabs[0]
    cache = [0] * (1 << cache_bits)
    shift = 32 - cache_bits
    cached = 0
    mw = _sub(w, meta_bits)
    i = 0
    while i < n:
        if meta is not None:
            y = i // w
            tg, mg, tr, mr, tb, mb, ta, ma, td, md = \
                tabs[meta[(y >> meta_bits) * mw + ((i - y * w) >> meta_bits)]]
        e = tg[(win[p >> 5] >> (p & 31)) & mg]
        p += e >> 16
        code = e & 0xFFFF
        if code < 256:
            e = tr[(win[p >> 5] >> (p & 31)) & mr]
            p += e >> 16
            red = e & 0xFFFF
            e = tb[(win[p >> 5] >> (p & 31)) & mb]
            p += e >> 16
            blue = e & 0xFFFF
            e = ta[(win[p >> 5] >> (p & 31)) & ma]
            p += e >> 16
            px[i] = (e & 0xFFFF) << 24 | red << 16 | code << 8 | blue
            i += 1
        elif code < 280:
            s = code - 256
            if s < 4:
                length = s + 1
            else:
                eb = (s - 2) >> 1
                length = ((2 + (s & 1)) << eb) + ((win[p >> 5] >> (p & 31)) & ((1 << eb) - 1)) + 1
                p += eb
            e = td[(win[p >> 5] >> (p & 31)) & md]
            p += e >> 16
            s = e & 0xFFFF
            if s < 4:
                dist = s + 1
            else:
                eb = (s - 2) >> 1
                dist = ((2 + (s & 1)) << eb) + ((win[p >> 5] >> (p & 31)) & ((1 << eb) - 1)) + 1
                p += eb
            dist = plane[dist - 1] if dist <= 120 else dist - 120
            if dist > i or i + length > n:
                raise _Fail
            if dist >= length:
                px[i:i + length] = px[i - dist:i - dist + length]
            else:
                px[i:i + length] = (px[i - dist:i] * (length // dist + 1))[:length]
            i += length
        else:
            if cached < i:
                _cache_insert(cache, px[cached:i], shift)
                cached = i
            px[i] = cache[code - 280]
            i += 1
    br.pos = p
    if p > br.end:
        raise _Fail
    return px


def _cache_insert(cache: List[int], values: List[int], shift: int) -> None:
    """Insert ``values`` in order into the colour cache (the last value of
    a hash wins): key = (0x1e35a7bd * argb mod 2**32) >> shift."""
    if len(values) < 64:
        for v in values:
            cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
        return
    vals = np.array(values[::-1], np.uint64)
    keys = ((vals * np.uint64(0x1E35A7BD)) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)
    keys, first = np.unique(keys, return_index=True)
    for k, v in zip(keys.tolist(), vals[first].tolist()):
        cache[k] = v


def _vp8l_image(br: _LBits, w: int, h: int, level0: bool) -> np.ndarray:
    """One image stream (RFC 9649 5): its transforms (the level-0 image
    only), colour cache, prefix codes and pixels -> (h, w) uint32 ARGB
    with the transforms undone."""
    transforms = []
    xsize = w
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen >> kind & 1:
                raise _Fail
            seen |= 1 << kind
            if kind in (0, 1):  # predictor, colour
                bits = br.read(3) + 2
                sub = _vp8l_image(br, _sub(xsize, bits), _sub(h, bits), False)
                transforms.append((kind, xsize, bits, sub))
            elif kind == 3:  # colour indexing
                count = br.read(8) + 1
                bits = 0 if count > 16 else 1 if count > 4 else 2 if count > 2 else 3
                pal = _vp8l_image(br, count, 1, False)
                transforms.append((kind, xsize, bits, _palette(pal[0], bits)))
                xsize = _sub(xsize, bits)
            else:  # subtract green
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _Fail
    meta, meta_bits, count = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        image = _vp8l_image(br, _sub(xsize, meta_bits), _sub(h, meta_bits), False)
        groups_of = ((image >> 8) & 0xFFFF).ravel()
        count = int(groups_of.max()) + 1
        meta = groups_of.tolist()
    groups = []
    for _ in range(count):
        groups.append([_read_code(br, size + ((1 << cache_bits) if j == 0 and cache_bits else 0))
                       for j, size in enumerate(_ALPHABETS)])
    px = np.array(_vp8l_pixels(br, xsize, h, groups, meta, meta_bits, cache_bits),
                  np.uint32).reshape(h, xsize)
    for kind, width, bits, tdata in reversed(transforms):
        if kind == 0:
            px = _unpredict(px, bits, tdata)
        elif kind == 1:
            px = _uncolor(px, bits, tdata)
        elif kind == 2:
            green = (px >> 8) & 0xFF
            px = (px & 0xFF00FF00) | (((px >> 16) + green) & 0xFF) << 16 | ((px + green) & 0xFF)
        else:
            px = _unindex(px, width, bits, tdata)
    return px


def _palette(pal: np.ndarray, bits: int) -> np.ndarray:
    """The colour-indexing palette, delta-coded byte by byte, padded with
    transparent black to 2 ** (8 >> bits) entries."""
    full = np.zeros((1 << (8 >> bits), 4), np.uint8)
    lanes = pal.astype("<u4").view(np.uint8).reshape(-1, 4)
    n = min(len(lanes), len(full))
    full[:n] = np.cumsum(lanes[:n], axis=0, dtype=np.uint64) & 0xFF
    return full.view("<u4").ravel()


def _unindex(px: np.ndarray, width: int, bits: int, pal: np.ndarray) -> np.ndarray:
    idx = (px >> 8) & 0xFF
    if bits:
        per, depth = 1 << bits, 8 >> bits
        mask = (1 << depth) - 1
        idx = np.stack([(idx >> (k * depth)) & mask for k in range(per)], -1)
        idx = idx.reshape(px.shape[0], -1)[:, :width]
    return pal[idx]


def _int8(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32) & 0xFF
    return v - ((v & 0x80) << 1)


def _uncolor(px: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """The inverse colour transform (``VP8LTransformColorInverse``)."""
    h, w = px.shape
    m = data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r, g2b, r2b = _int8(m), _int8(m >> 8), _int8(m >> 16)
    green = _int8(px >> 8)
    red = ((px >> 16).astype(np.int32) + ((g2r * green) >> 5)) & 0xFF
    blue = ((px & 0xFF).astype(np.int32) + ((g2b * green) >> 5)
            + ((r2b * _int8(red)) >> 5)) & 0xFF
    return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def _avg(a, b):
    return (a + b) >> 1


def _unpredict(px: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """The inverse predictor transform (RFC 9649 4.1).  The first row
    predicts from the left (its first pixel from opaque black), the
    first column from above; every other pixel by its block's mode from
    its left (L), top (T), top-left (TL) and top-right (TR) neighbours,
    TR of the last column being the row's first pixel.  A pixel depends on
    pixels with a smaller 2y + x only, so those lines are undone one at a
    time, every pixel of a line at once."""
    h, w = px.shape
    res = px.view(np.uint8).reshape(h * w, 4).astype(np.int32)  # B G R A
    out = np.zeros_like(res)
    black = np.array([0, 0, 0, 255], np.int32)
    first = res[:w].copy()
    first[0] += black
    out[:w] = np.cumsum(first, axis=0) & 0xFF
    if h > 1:
        col = res[w::w].copy()
        col[0] += out[0]
        out[w::w] = np.cumsum(col, axis=0) & 0xFF
    if h > 1 and w > 1:
        ys, xs = np.mgrid[1:h, 1:w]
        modes = ((data[ys >> bits, xs >> bits] >> 8) & 0xF).astype(np.int64)
        if (modes >= 14).any():
            raise _Unsupported(f"lossless predictor mode {int(modes.max())}")
        t = (2 * ys + xs).ravel()
        order = np.argsort(t, kind="stable")
        flat = (ys * w + xs).ravel()[order]
        modes = modes.ravel()[order]
        bounds = np.searchsorted(t[order], np.arange(t.min(), t.max() + 2))
        for k in range(len(bounds) - 1):
            f = flat[bounds[k]:bounds[k + 1]]
            m = modes[bounds[k]:bounds[k + 1]]
            left, top = out[f - 1], out[f - w]
            tl, tr = out[f - w - 1], out[f - w + 1]
            pred = _predict(m, left, top, tl, tr, black)
            out[f] = (pred + res[f]) & 0xFF
    return out.astype(np.uint8).view("<u4").reshape(h, w)


def _predict(m, left, top, tl, tr, black):
    """The 14 predictors for pixels of modes ``m``: (n, 4) int32 BGRA
    lanes each."""
    pred = np.empty_like(left)
    for mode in np.unique(m).tolist():
        sel = m == mode
        L, T, TL, TR = left[sel], top[sel], tl[sel], tr[sel]
        if mode == 1:
            v = L
        elif mode == 2:
            v = T
        elif mode == 3:
            v = TR
        elif mode == 4:
            v = TL
        elif mode == 5:
            v = _avg(_avg(L, TR), T)
        elif mode == 6:
            v = _avg(L, TL)
        elif mode == 7:
            v = _avg(L, T)
        elif mode == 8:
            v = _avg(TL, T)
        elif mode == 9:
            v = _avg(T, TR)
        elif mode == 10:
            v = _avg(_avg(L, TL), _avg(T, TR))
        elif mode == 11:  # Select: T when L is nearer TL than T is
            closer = (np.abs(L - TL).sum(-1) - np.abs(T - TL).sum(-1)) <= 0
            v = np.where(closer[:, None], T, L)
        elif mode == 12:
            v = np.clip(L + T - TL, 0, 255)
        elif mode == 13:
            a = _avg(L, T)
            d = a - TL
            v = np.clip(a + np.where(d < 0, -((-d) >> 1), d >> 1), 0, 255)
        else:  # 0
            v = black
        pred[sel] = v
    return pred


def _vp8l_stream(data: bytes, start: int, w: int, h: int) -> np.ndarray:
    """The level-0 image stream at bit ``start`` of ``data`` -> (h, w)
    uint32 ARGB; a stream that reads past its padded end fails as
    libwebp's end-of-stream check does."""
    br = _LBits(data)
    br.pos = start
    try:
        return _vp8l_image(br, w, h, True)
    except IndexError:
        raise _Fail from None


def _vp8l_decode(body: bytes, w: int, h: int) -> np.ndarray:
    """A VP8L chunk's body -> (h, w) uint32 ARGB."""
    return _vp8l_stream(body, 8 + 14 + 14 + 1 + 3, w, h)


# ---------------------------------------------------------------------------
# alpha: ALPH
# ---------------------------------------------------------------------------

def _alpha(chunk: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk (RFC 9649 2.7) -> (h, w) uint8: raw or VP8L-coded
    (an image stream with no header, alpha its green), then unfiltered.
    The pre-processing bits only ask for optional dithering, which cv2
    leaves off."""
    if not chunk:
        raise _Fail
    method, kind = chunk[0] & 3, (chunk[0] >> 2) & 3
    if method > 1 or (chunk[0] >> 4) & 3 > 1 or chunk[0] >> 6:
        raise _Fail
    if method == 0:
        if len(chunk) - 1 < w * h:
            raise _Fail
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        argb = _vp8l_stream(chunk[1:], 0, w, h)
        a = ((argb >> 8) & 0xFF).astype(np.uint8)
    return _unfilter_alpha(a, kind)


def _unfilter_alpha(a: np.ndarray, kind: int) -> np.ndarray:
    """Undo the alpha filter (``WebPUnfilters``): horizontal and vertical
    as running sums, gradient along anti-diagonals (a pixel depends on its
    left, top and top-left neighbours)."""
    if kind == 0:
        return a
    h, w = a.shape
    v = a.astype(np.int64)
    if kind == 1:
        v[:, 0] = np.cumsum(v[:, 0])
        return (np.cumsum(v, axis=1) & 0xFF).astype(np.uint8)
    v[0] = np.cumsum(v[0])
    if kind == 2:
        return (np.cumsum(v, axis=0) & 0xFF).astype(np.uint8)
    v[:, 0] = np.cumsum(v[:, 0])
    v &= 0xFF
    for d in range(2, h + w - 1):
        y = np.arange(max(1, d - w + 1), min(h, d))
        x = d - y
        pred = np.clip(v[y, x - 1] + v[y - 1, x] - v[y - 1, x - 1], 0, 255)
        v[y, x] = (v[y, x] + pred) & 0xFF
    return v.astype(np.uint8)


# ---------------------------------------------------------------------------
# lossy: VP8 key frames
# ---------------------------------------------------------------------------

#: range -> (range << shift) - 1 and shift, after a decision (RFC 6386 7.3:
#: the range kept less one, as libwebp keeps it)
_SHIFT = [0] + [7 - r.bit_length() + 1 for r in range(1, 256)]
_RANGE = [0] + [(r << _SHIFT[r]) - 1 for r in range(1, 256)]


class _Bool:
    """RFC 6386 7's boolean decoder as libwebp runs it (``VP8GetBit``):
    the range kept less one, the value loaded a byte at a time, ``eof``
    set where libwebp sets it (when a bit needs a byte past the last)."""

    __slots__ = ("buf", "n", "pos", "value", "rng", "bits", "eof")

    def __init__(self, buf: bytes):
        self.buf, self.n, self.pos = buf, len(buf), 0
        self.value, self.rng, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos < self.n:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
        else:
            self.value <<= 8
            self.eof = True
        self.bits += 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        bits = self.bits
        split = (self.rng * prob) >> 8
        if (self.value >> bits) > split:
            r = self.rng - split
            self.value -= (split + 1) << bits
            bit = 1
        else:
            r = split + 1
            bit = 0
        self.rng = _RANGE[r]
        self.bits = bits - _SHIFT[r]
        return bit

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.get(n)
        return -v if self.bit(128) else v


def _clip(v: int, top: int) -> int:
    return 0 if v < 0 else top if v > top else v


#: 4x4 sub-block modes (libwebp's order) and the 16x16 / chroma modes
_B_DC, _B_TM, _B_VE, _B_HE, _B_RD, _B_VR, _B_LD, _B_VL, _B_HD, _B_HU = range(10)
_DC_PRED, _TM_PRED, _V_PRED, _H_PRED = _B_DC, _B_TM, _B_VE, _B_HE


def _frame_header(br: _Bool) -> dict:
    """The key frame's header from the first partition (RFC 6386 9.3-9.6,
    9.9-9.11; libwebp's ``VP8GetHeaders``)."""
    br.bit(128)  # colour space: libwebp ignores it
    br.bit(128)  # clamping type: libwebp always clamps
    hdr = dict(use_segment=br.get(1), update_map=0, seg_q=[0] * 4, seg_lf=[0] * 4,
               seg_probs=[255, 255, 255])
    if hdr["use_segment"]:
        hdr["update_map"] = br.get(1)
        if br.get(1):  # update the segments' data
            if not br.get(1):
                raise _Unsupported("segment values relative to the frame's")
            hdr["seg_q"] = [br.signed(7) if br.get(1) else 0 for _ in range(4)]
            hdr["seg_lf"] = [br.signed(6) if br.get(1) else 0 for _ in range(4)]
        if hdr["update_map"]:
            hdr["seg_probs"] = [br.get(8) if br.get(1) else 255 for _ in range(3)]
        else:
            raise _Unsupported("segment map kept from an earlier frame")
    simple, level, sharpness = br.get(1), br.get(6), br.get(3)
    if br.get(1):
        raise _Unsupported("loop-filter deltas")
    if level and simple:
        raise _Unsupported("simple loop filter")
    if level and sharpness:
        raise _Unsupported(f"loop-filter sharpness {sharpness}")
    hdr["filter_level"] = level
    parts = 1 << br.get(2)
    if parts > 1:
        raise _Unsupported(f"{parts} token partitions")
    base = br.get(7)
    deltas = [br.signed(4) if br.get(1) else 0 for _ in range(5)]
    hdr["quant"] = _quantizers(hdr, base, deltas)
    return hdr


def _quantizers(hdr: dict, base: int, deltas: List[int]) -> List[Tuple[int, ...]]:
    """(y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac) per segment
    (``VP8ParseQuant``)."""
    y1_dc, y2_dc, y2_ac, uv_dc, uv_ac = deltas
    out = []
    for s in range(4):
        q = hdr["seg_q"][s] if hdr["use_segment"] else base
        y2a = (_AC_TABLE[_clip(q + y2_ac, 127)] * 101581) >> 16
        out.append((_DC_TABLE[_clip(q + y1_dc, 127)], _AC_TABLE[_clip(q, 127)],
                    _DC_TABLE[_clip(q + y2_dc, 127)] * 2, max(y2a, 8),
                    _DC_TABLE[_clip(q + uv_dc, 117)], _AC_TABLE[_clip(q + uv_ac, 127)]))
    return out


def _probabilities(br: _Bool) -> Tuple[list, int]:
    """The coefficient probabilities with this frame's updates, as
    P[type][n][ctx] -> the 11 probabilities of coefficient n's band, for
    n in 0..16; and the skip probability (-1 when unused)."""
    probs = [br.get(8) if br.bit(_COEFFS_UPDATE_PROBA[i]) else _COEFFS_PROBA0[i]
             for i in range(4 * 8 * 3 * 11)]
    table = []
    for t in range(4):
        bands = [[probs[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
                  for c in range(3)] for b in range(8)]
        table.append([bands[_BANDS[n]] for n in range(17)])
    skip = br.get(8) if br.get(1) else -1
    return table, skip


def _intra_modes(br: _Bool, hdr: dict, mbw: int, mbh: int, skip_prob: int):
    """Each macroblock's segment, skip flag, 4x4 flag, luma modes (16 for
    4x4 blocks, else 1) and chroma mode (libwebp's ``ParseIntraMode``: the
    4x4 modes' probabilities by the modes above and to the left)."""
    seg, skip, is4, ymodes, uvmodes = [], [], [], [], []
    top = [_B_DC] * (4 * mbw)
    update_map, sp = hdr["update_map"], hdr["seg_probs"]
    bit, pb = br.bit, _BMODES_PROBA
    for _ in range(mbh):
        left = [_B_DC] * 4
        for x in range(mbw):
            if update_map:
                seg.append(bit(sp[1]) if not bit(sp[0]) else bit(sp[2]) + 2)
            else:
                seg.append(0)
            skip.append(bit(skip_prob) if skip_prob >= 0 else 0)
            if bit(145):
                mode = (_TM_PRED if bit(128) else _H_PRED) if bit(156) else \
                    (_V_PRED if bit(163) else _DC_PRED)
                top[4 * x:4 * x + 4] = [mode] * 4
                left = [mode] * 4
                is4.append(0)
                ymodes.append([mode])
            else:
                modes = []
                for y in range(4):
                    m = left[y]
                    for i in range(4):
                        o = (top[4 * x + i] * 10 + m) * 9
                        if not bit(pb[o]):
                            m = _B_DC
                        elif not bit(pb[o + 1]):
                            m = _B_TM
                        elif not bit(pb[o + 2]):
                            m = _B_VE
                        elif not bit(pb[o + 3]):
                            m = _B_HE if not bit(pb[o + 4]) else (
                                _B_RD if not bit(pb[o + 5]) else _B_VR)
                        else:
                            m = _B_LD if not bit(pb[o + 6]) else (
                                _B_VL if not bit(pb[o + 7]) else (
                                    _B_HD if not bit(pb[o + 8]) else _B_HU))
                        top[4 * x + i] = m
                        modes.append(m)
                    left[y] = m
                is4.append(1)
                ymodes.append(modes)
            uvmodes.append(_DC_PRED if not bit(142) else _V_PRED if not bit(114) else
                           _TM_PRED if bit(183) else _H_PRED)
        if br.eof:
            raise _Fail
    return seg, skip, is4, ymodes, uvmodes


#: per block of a macroblock (16 Y, 4 U, 4 V, then Y2): the slots of its
#: above and left non-zero flags among a column's / row's nine
#: (4 Y, 2 U, 2 V, 1 Y2)
_Y_SLOTS = [(k % 4, k // 4) for k in range(16)]
_UV_SLOTS = [(4 + k % 2, 4 + k // 2) for k in range(4)] + [(6 + k % 2, 6 + k // 2)
                                                          for k in range(4)]


def _vp8_tokens(br: _Bool, probs, quant, seg, skip, is4, mbw: int, mbh: int):
    """Every macroblock's coefficients (RFC 6386 13; libwebp's
    ``ParseResiduals`` and ``GetCoeffs``), dequantised, in natural order:
    (mbs, 25, 16) int32 (blocks 0-15 Y, 16-19 U, 20-23 V, 24 Y2), and the
    position past each block's last coefficient (mbs, 25).  The boolean
    decoder is inlined: this loop is where a lossy file's time goes."""
    nmb = mbw * mbh
    coef = array("i", bytes(4 * nmb * 400))
    nzs = array("i", bytes(4 * nmb * 25))
    zig, rng_t, sh_t, large, cats = _ZIGZAG, _RANGE, _SHIFT, _LARGE, _CATS
    buf, n_buf, pos, value, rng, bits = br.buf, br.n, br.pos, br.value, br.rng, br.bits
    eof = br.eof
    top = [0] * (9 * mbw)
    mb = 0
    # (type, first coefficient, offset, above slot, left slot) per block
    uv_plan = [(2, 0, (16 + k) * 16, t, l) for k, (t, l) in enumerate(_UV_SLOTS)]
    y_plan_i16 = [(1, 0, 384, 8, 8)] + [(0, 1, k * 16, t, l)
                                        for k, (t, l) in enumerate(_Y_SLOTS)] + uv_plan
    y_plan_i4 = [(3, 0, k * 16, t, l) for k, (t, l) in enumerate(_Y_SLOTS)] + uv_plan
    for _ in range(mbh):
        left = [0] * 9
        for x in range(mbw):
            tb = 9 * x
            if skip[mb]:
                for k in range(8):
                    top[tb + k] = 0
                    left[k] = 0
                if not is4[mb]:
                    top[tb + 8] = left[8] = 0
                mb += 1
                continue
            q = quant[seg[mb]]
            base = mb * 400
            plan = y_plan_i4 if is4[mb] else y_plan_i16
            for t, first, off, ts, ls in plan:
                if t == 1 or t == 3:
                    dq0, dq1 = (q[2], q[3]) if t == 1 else (q[0], q[1])
                elif t == 0:
                    dq0, dq1 = q[0], q[1]
                else:
                    dq0, dq1 = q[4], q[5]
                pt = probs[t]
                n = first
                p = pt[n][top[tb + ts] + left[ls]]
                o = base + off
                while n < 16:
                    # the end-of-block decision, p[0]
                    if bits < 0:
                        if pos < n_buf:
                            value = (value << 8) | buf[pos]
                            pos += 1
                        else:
                            value <<= 8
                            eof = True
                        bits += 8
                    split = (rng * p[0]) >> 8
                    if (value >> bits) > split:
                        r = rng - split
                        value -= (split + 1) << bits
                        rng = rng_t[r]
                        bits -= sh_t[r]
                    else:
                        r = split + 1
                        rng = rng_t[r]
                        bits -= sh_t[r]
                        break
                    # zeros, p[1]
                    while True:
                        if bits < 0:
                            if pos < n_buf:
                                value = (value << 8) | buf[pos]
                                pos += 1
                            else:
                                value <<= 8
                                eof = True
                            bits += 8
                        split = (rng * p[1]) >> 8
                        if (value >> bits) > split:
                            r = rng - split
                            value -= (split + 1) << bits
                            rng = rng_t[r]
                            bits -= sh_t[r]
                            break
                        r = split + 1
                        rng = rng_t[r]
                        bits -= sh_t[r]
                        n += 1
                        if n == 16:
                            break
                        p = pt[n][0]
                    if n == 16:
                        break
                    # one, p[2], or a larger value
                    if bits < 0:
                        if pos < n_buf:
                            value = (value << 8) | buf[pos]
                            pos += 1
                        else:
                            value <<= 8
                            eof = True
                        bits += 8
                    split = (rng * p[2]) >> 8
                    if (value >> bits) > split:
                        r = rng - split
                        value -= (split + 1) << bits
                        rng = rng_t[r]
                        bits -= sh_t[r]
                        # a value above 1: GetLargeValue's tree, a step a decision
                        step = 0
                        while step >= 0:
                            src, step0, step1 = large[step]
                            if bits < 0:
                                if pos < n_buf:
                                    value = (value << 8) | buf[pos]
                                    pos += 1
                                else:
                                    value <<= 8
                                    eof = True
                                bits += 8
                            split = (rng * (p[src] if src >= 0 else -src)) >> 8
                            if (value >> bits) > split:
                                r = rng - split
                                value -= (split + 1) << bits
                                step = step1
                            else:
                                r = split + 1
                                step = step0
                            rng = rng_t[r]
                            bits -= sh_t[r]
                        if step > -100:
                            v = -step
                        else:  # categories 3-6: extra bits, most significant first
                            cat = -step - 100
                            v = 0
                            for prob in cats[cat]:
                                if bits < 0:
                                    if pos < n_buf:
                                        value = (value << 8) | buf[pos]
                                        pos += 1
                                    else:
                                        value <<= 8
                                        eof = True
                                    bits += 8
                                split = (rng * prob) >> 8
                                if (value >> bits) > split:
                                    r = rng - split
                                    value -= (split + 1) << bits
                                    v = 2 * v + 1
                                else:
                                    r = split + 1
                                    v = 2 * v
                                rng = rng_t[r]
                                bits -= sh_t[r]
                            v += 3 + (8 << cat)
                        pn = pt[n + 1][2]
                    else:
                        r = split + 1
                        rng = rng_t[r]
                        bits -= sh_t[r]
                        v = 1
                        pn = pt[n + 1][1]
                    # the sign, at probability one half
                    if bits < 0:
                        if pos < n_buf:
                            value = (value << 8) | buf[pos]
                            pos += 1
                        else:
                            value <<= 8
                            eof = True
                        bits += 8
                    split = (rng * 128) >> 8
                    if (value >> bits) > split:
                        r = rng - split
                        value -= (split + 1) << bits
                        v = -v
                    else:
                        r = split + 1
                    rng = rng_t[r]
                    bits -= sh_t[r]
                    coef[o + zig[n]] = v * (dq1 if n else dq0)
                    n += 1
                    p = pn
                nzs[mb * 25 + off // 16] = n
                flag = 1 if n > first else 0
                top[tb + ts] = flag
                left[ls] = flag
            if eof:
                raise _Fail
            mb += 1
    return (np.frombuffer(coef, np.int32).reshape(nmb, 25, 16),
            np.frombuffer(nzs, np.int32).reshape(nmb, 25))


#: libwebp's ``GetLargeValue`` as steps: (the probability, p[i] for i >= 0
#: or the constant -i; the next step after a 0, after a 1), a next step
#: below 0 ending the walk: -v for a value v, -100 - c for category c
#: (Pcat3 + c, its extra bits to read)
_LARGE = ((3, 1, 3), (4, -2, 2), (5, -3, -4), (6, 4, 8), (7, 5, 6), (-159, -5, -6),
          (-165, 7, 11), (-145, -7, -8), (8, 9, 10), (9, -100, -101), (10, -102, -103),
          (-145, -9, -10))
_CATS = [_CAT3[:-1], _CAT4[:-1], _CAT5[:-1], _CAT6[:-1]]


def _wht(dc: np.ndarray) -> np.ndarray:
    """The inverse Walsh-Hadamard transform of Y2 blocks (``TransformWHT``):
    (n, 16) -> the (n, 16) DCs of each macroblock's 16 Y blocks."""
    d = dc.reshape(-1, 4, 4).astype(np.int64)
    a0, a1 = d[:, 0] + d[:, 3], d[:, 1] + d[:, 2]
    a2, a3 = d[:, 1] - d[:, 2], d[:, 0] - d[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)  # t[:, r, i] = tmp[4r + i]
    dc0 = t[..., 0] + 3
    b0, b1 = dc0 + t[..., 3], t[..., 1] + t[..., 2]
    b2, b3 = t[..., 1] - t[..., 2], dc0 - t[..., 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], axis=-1)
    return out.reshape(-1, 16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _w16(x):
    """Wrap to int16, as an SSE2 lane does."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct(c: np.ndarray, lanes: np.ndarray) -> np.ndarray:
    """The inverse DCT of (n, 16) coefficients in natural order -> (n, 4,
    4) residuals, the values added to the prediction.  Blocks with
    ``lanes`` set take libwebp's SSE2 ``Transform`` (every sum wrapped to
    16 bits; its constants split so that each product is exact), the
    others ``TransformOne``'s C arithmetic (its DC-only and three-
    coefficient shortcuts, which libwebp runs in C, give the same).  The
    two differ only on coefficients no encoder writes."""
    c = c.reshape(-1, 4, 4).astype(np.int64)
    wrap = lanes[:, None]
    w = (lambda x: np.where(wrap, _w16(x), x)) if lanes.any() else (lambda x: x)

    def one_pass(r0, r1, r2, r3, dc):
        a, b = w(r0 + dc + r2), w(r0 + dc - r2)
        cc = w(w(r1 - r3) + w(_mul2(r1) - r1 - ((r3 * 20091) >> 16)))
        d = w(w(r1 + r3) + w(((r1 * 20091) >> 16) + _mul2(r3) - r3))
        return w(a + d), w(b + cc), w(b - cc), w(a - d)

    t = np.stack(one_pass(c[:, 0], c[:, 1], c[:, 2], c[:, 3], 0), axis=-1)  # [:, col, k]
    out = one_pass(t[:, 0], t[:, 1], t[:, 2], t[:, 3], 4)
    return np.stack([o >> 3 for o in out], axis=-1)  # [:, row, column]


# the 4x4 predictions read a bank of samples per block: the 15 edge
# samples L L K J I X A B C D E F G H H (I..L the left column downwards,
# X the corner, A..D above, E..H above right, the end ones repeated), the
# 13 AVG3 of three consecutive ones, the 14 AVG2 of two, DC, and TM's 16
_EDGE = {c: i for i, c in enumerate("LLKJIXABCDEFGHH") if i not in (0, 14)}


def _a3(c: str) -> int:
    return 15 + _EDGE[c] - 1


def _a2(a: str, b: str) -> int:
    return 28 + min(_EDGE[a], _EDGE[b])


def _bmode_table() -> np.ndarray:
    """(10 modes, 16 pixels in raster order) -> bank index, from
    libwebp's ``VE4`` .. ``HU4`` (``DST(x, y)``)."""
    t = np.zeros((10, 4, 4), np.int64)  # [mode, y, x]
    t[_B_DC] = 42
    t[_B_TM] = 43 + np.arange(16).reshape(4, 4)
    t[_B_VE] = [_a3(c) for c in "ABCD"]
    t[_B_HE] = np.array([_a3(c) for c in "IJKL"])[:, None]
    for y in range(4):
        for x in range(4):
            t[_B_RD, y, x] = _a3("KJIXABC"[3 + x - y])
            t[_B_LD, y, x] = _a3("BCDEFGH"[x + y])
    vr = {(0, 0): _a2("X", "A"), (1, 2): _a2("X", "A"), (1, 0): _a2("A", "B"),
          (2, 2): _a2("A", "B"), (2, 0): _a2("B", "C"), (3, 2): _a2("B", "C"),
          (3, 0): _a2("C", "D"), (0, 3): _a3("J"), (0, 2): _a3("I"), (0, 1): _a3("X"),
          (1, 3): _a3("X"), (1, 1): _a3("A"), (2, 3): _a3("A"), (2, 1): _a3("B"),
          (3, 3): _a3("B"), (3, 1): _a3("C")}
    vl = {(0, 0): _a2("A", "B"), (1, 0): _a2("B", "C"), (0, 2): _a2("B", "C"),
          (2, 0): _a2("C", "D"), (1, 2): _a2("C", "D"), (3, 0): _a2("D", "E"),
          (2, 2): _a2("D", "E"), (0, 1): _a3("B"), (1, 1): _a3("C"), (0, 3): _a3("C"),
          (2, 1): _a3("D"), (1, 3): _a3("D"), (3, 1): _a3("E"), (2, 3): _a3("E"),
          (3, 2): _a3("F"), (3, 3): _a3("G")}
    hd = {(0, 0): _a2("I", "X"), (2, 1): _a2("I", "X"), (0, 1): _a2("J", "I"),
          (2, 2): _a2("J", "I"), (0, 2): _a2("K", "J"), (2, 3): _a2("K", "J"),
          (0, 3): _a2("L", "K"), (3, 0): _a3("B"), (2, 0): _a3("A"), (1, 0): _a3("X"),
          (3, 1): _a3("X"), (1, 1): _a3("I"), (3, 2): _a3("I"), (1, 2): _a3("J"),
          (3, 3): _a3("J"), (1, 3): _a3("K")}
    hu = {(0, 0): _a2("I", "J"), (2, 0): _a2("J", "K"), (0, 1): _a2("J", "K"),
          (2, 1): _a2("K", "L"), (0, 2): _a2("K", "L"), (1, 0): _a3("J"),
          (3, 0): _a3("K"), (1, 1): _a3("K"), (3, 1): _a3("L"), (1, 2): _a3("L")}
    for mode, spec in ((_B_VR, vr), (_B_VL, vl), (_B_HD, hd), (_B_HU, hu)):
        t[mode] = _EDGE["L"]  # HU's lower right is L itself
        for (x, y), v in spec.items():
            t[mode, y, x] = v
    return t.reshape(10, 16)


_BMODE_INDEX = _bmode_table()
_AR4, _AR8, _AR16 = np.arange(4), np.arange(8), np.arange(16)
#: the 4x4 blocks of a macroblock by the line 2i + j they are decoded on
_BLOCK_LINES = [[(i, s - 2 * i) for i in range(4) if 0 <= s - 2 * i < 4] for s in range(10)]


def _wavefronts(mbw: int, mbh: int) -> List[np.ndarray]:
    """Macroblock indices by 2y + x: a macroblock's prediction and loop
    filter read only macroblocks on earlier lines."""
    t = 2 * (np.arange(mbw * mbh) // mbw) + np.arange(mbw * mbh) % mbw
    order = np.argsort(t, kind="stable")
    return np.split(order, np.searchsorted(t[order], np.arange(1, t.max() + 1)))


def _predict_planes(mbw: int, mbh: int, is4, ymodes, uvmodes, res: np.ndarray):
    """Intra prediction plus residual (RFC 6386 12; libwebp's
    ``ReconstructRow``) -> the unfiltered Y, U and V planes, whole
    macroblocks.  The planes carry a border row of 127 above and a column
    of 129 left (the corner 127), so edge macroblocks read libwebp's
    values; a 4x4 block on the right column takes its above-right pixels
    from the macroblock row above (the last macroblock repeats its own
    above pixel 15, the first row 127), not from its right neighbour."""
    W, H = 16 * mbw, 16 * mbh
    planes = []
    for size in (16, 8, 8):
        p = np.zeros((mbh * size + 1, mbw * size + 1), np.int64)
        p[0] = 127
        p[1:, 0] = 129
        planes.append(p)
    Y, U, V = planes
    yf = Y.reshape(-1)
    wy = W + 1
    is4 = np.asarray(is4, bool)
    y16 = np.array([m[0] if not f else 0 for m, f in zip(ymodes, is4)])
    y4 = np.array([m if f else [0] * 16 for m, f in zip(ymodes, is4)], np.int64)
    uvm = np.asarray(uvmodes)
    for mbs in _wavefronts(mbw, mbh):
        my, mx = mbs // mbw, mbs % mbw
        sel = ~is4[mbs]
        if sel.any():
            _predict_whole(Y, 16, mbs[sel], my[sel], mx[sel], y16[mbs[sel]],
                           res[mbs[sel], :16])
        sel = is4[mbs]
        if sel.any():
            _predict_4x4(yf, wy, mbw, mbs[sel], my[sel], mx[sel], y4, res)
        for plane, first in ((U, 16), (V, 20)):
            _predict_whole(plane, 8, mbs, my, mx, uvm[mbs], res[mbs, first:first + 4])
    return Y[1:, 1:], U[1:, 1:], V[1:, 1:]


def _tile(blocks: np.ndarray) -> np.ndarray:
    """(n, k*k, 4, 4) raster-ordered blocks -> (n, 4k, 4k)."""
    n, kk = blocks.shape[:2]
    k = int(round(kk ** 0.5))
    return blocks.reshape(n, k, k, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 4 * k, 4 * k)


def _predict_whole(P, size, mbs, my, mx, modes, res):
    """16x16 luma or 8x8 chroma prediction of macroblocks (DC, with
    libwebp's variants on the frame's edges; V; H; TM) plus residual."""
    ar = np.arange(size)
    r0, c0 = size * my, size * mx
    top = P[r0[:, None], c0[:, None] + 1 + ar]
    left = P[r0[:, None] + 1 + ar, c0[:, None]]
    corner = P[r0, c0]
    shift = 5 if size == 16 else 4
    both = (top.sum(1) + left.sum(1) + size) >> shift
    no_top = (left.sum(1) + size // 2) >> (shift - 1)
    no_left = (top.sum(1) + size // 2) >> (shift - 1)
    dc = np.where(mx > 0, np.where(my > 0, both, no_top), np.where(my > 0, no_left, 128))
    tm = np.clip(top[:, None, :] + left[:, :, None] - corner[:, None, None], 0, 255)
    m = modes[:, None, None]
    pred = np.where(m == _DC_PRED, dc[:, None, None],
                    np.where(m == _V_PRED, top[:, None, :],
                             np.where(m == _H_PRED, left[:, :, None], tm)))
    rows = r0[:, None, None] + 1 + ar[None, :, None]
    cols = c0[:, None, None] + 1 + ar[None, None, :]
    P[rows, cols] = np.clip(_w16(pred + _tile(res)), 0, 255)


def _predict_4x4(yf, wy, mbw, mbs, my, mx, y4, res):
    """The ten 4x4 modes of macroblocks' blocks, one line 2i + j of blocks
    at a time (a block reads its left, upper, upper-left and upper-right
    neighbours, which lie on earlier lines)."""
    top_row = (16 * my) * wy
    right = np.where(my == 0, 0, np.where(mx == mbw - 1, top_row + 16 * mx + 16, -1))
    for line in _BLOCK_LINES:
        ii = np.repeat(np.array([i for i, _ in line]), len(mbs))
        jj = np.repeat(np.array([j for _, j in line]), len(mbs))
        m = np.tile(mbs, len(line))
        r0 = np.tile(16 * my, len(line)) + 4 * ii
        c0 = np.tile(16 * mx, len(line)) + 4 * jj
        above = r0 * wy + c0
        left = (r0[:, None] + 1 + _AR4) * wy + c0[:, None]
        ar_idx = above[:, None] + 5 + _AR4
        last = jj == 3
        rep = np.tile(right, len(line))
        tr = np.tile(top_row + 16 * mx + 17, len(line))[:, None] + _AR4
        tr = np.where((rep >= 0)[:, None], rep[:, None], tr)
        ar_idx = np.where(last[:, None], tr, ar_idx)
        idx = np.concatenate([left[:, 3:], left[:, ::-1], above[:, None],
                              above[:, None] + 1 + _AR4, ar_idx, ar_idx[:, 3:]], axis=1)
        e = yf[idx]
        a3 = (e[:, :13] + 2 * e[:, 1:14] + e[:, 2:] + 2) >> 2
        a2 = (e[:, :14] + e[:, 1:] + 1) >> 1
        dc = (e[:, 6:10].sum(1) + e[:, 1:5].sum(1) + 4) >> 3
        tm = np.clip(e[:, None, 6:10] + e[:, [4, 3, 2, 1], None] - e[:, 5, None, None], 0, 255)
        bank = np.concatenate([e, a3, a2, dc[:, None], tm.reshape(-1, 16)], axis=1)
        k = 4 * ii + jj
        pred = np.take_along_axis(bank, _BMODE_INDEX[y4[m, k]], axis=1)
        out = np.clip(_w16(pred + res[m, k].reshape(-1, 16)), 0, 255)
        dst = ((r0[:, None] + 1 + _AR4) * wy)[:, :, None] + (c0[:, None] + 1 + _AR4)[:, None, :]
        yf[dst.reshape(-1, 16)] = out


def _filter_strengths(hdr: dict) -> np.ndarray:
    """(segment, 4x4 flag) -> (limit, interior limit, hev threshold)
    (libwebp's ``PrecomputeFilterStrengths``; sharpness 0 and no deltas,
    the rest refused); a limit of 0 filters nothing."""
    out = np.zeros((4, 2, 3), np.int64)
    for s in range(4):
        level = hdr["seg_lf"][s] if hdr["use_segment"] else hdr["filter_level"]
        level = _clip(level, 63)
        if level > 0:
            out[s, :] = (2 * level + level, level, 2 if level >= 40 else 1 if level >= 15 else 0)
    return out


def _edge(P, rows, cols, limit, ilevel, hev_t, outer: bool):
    """The normal loop filter across one edge of several macroblocks: the
    8 pixels p3..q3 across the edge on the last axis of (n, L, 8); each
    macroblock its own limits ((n, 1) arrays; libwebp's ``FilterLoop26``
    on macroblock edges, ``FilterLoop24`` inside)."""
    px = P[rows, cols]
    p3, p2, p1, p0, q0, q1, q2, q3 = (px[..., k] for k in range(8))
    mask = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= 2 * limit + 1
    inner = np.maximum.reduce([np.abs(p3 - p2), np.abs(p2 - p1), np.abs(p1 - p0),
                               np.abs(q3 - q2), np.abs(q2 - q1), np.abs(q1 - q0)])
    mask &= inner <= ilevel
    if not mask.any():
        return
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    outer_taps = np.clip(p1 - q1, -128, 127)
    a = 3 * (q0 - p0) + outer_taps
    h1, h2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    if outer:  # six taps (RFC 6386 15.3's MB filter)
        w = np.clip(a, -128, 127)
        f1, f2, f3 = (27 * w + 63) >> 7, (18 * w + 63) >> 7, (9 * w + 63) >> 7
        taps = {1: f3, 2: f2, 3: f1, 4: -f1, 5: -f2, 6: -f3}
    else:  # four taps (the subblock filter)
        b = 3 * (q0 - p0)
        g1, g2 = np.clip((b + 4) >> 3, -16, 15), np.clip((b + 3) >> 3, -16, 15)
        g3 = (g1 + 1) >> 1
        taps = {2: g3, 3: g2, 4: -g1, 5: -g3}
    # high edge variance: p0 and q0 only, with the outer taps
    delta = np.zeros_like(px)
    delta[..., 3] = np.where(mask & hev, h2, 0)
    delta[..., 4] = np.where(mask & hev, -h1, 0)
    for k, v in taps.items():
        delta[..., k] += np.where(mask & ~hev, v, 0)
    P[rows, cols] = np.clip(px + delta, 0, 255)


def _loop_filter(Y, UV, mbw, mbh, strengths, seg, is4, inner):
    """The normal loop filter over whole macroblocks, in libwebp's order
    for each macroblock (left edge, inner vertical edges, top edge, inner
    horizontal edges) on pixels already filtered.  Macroblocks on one line
    2y + x touch disjoint pixels, so a line's edges of one kind are one
    update.  ``UV`` is U and V side by side; a macroblock's inner edges
    are filtered when it is 4x4-predicted or has a non-zero coefficient."""
    seg, is4, inner = np.asarray(seg), np.asarray(is4, int), np.asarray(inner, bool)
    for mbs in _wavefronts(mbw, mbh):
        lim, ilev, hev = strengths[seg[mbs], is4[mbs]].T
        keep = lim > 0
        if not keep.any():
            continue
        mbs, lim, ilev, hev = mbs[keep], lim[keep], ilev[keep], hev[keep]
        my, mx = mbs // mbw, mbs % mbw
        for outer, across, sel in ((True, 1, mx > 0), (False, 1, inner[mbs]),
                                   (True, 0, my > 0), (False, 0, inner[mbs])):
            if not sel.any():
                continue
            y0, x0 = my[sel], mx[sel]
            t = (lim[sel] + (4 if outer else 0))[:, None]
            i, h = ilev[sel][:, None], hev[sel][:, None]
            for off in ((0,) if outer else (4, 8, 12)):
                _plane_edge(Y, 16, y0, x0, off, across, t, i, h, outer)
            y2, x2 = np.concatenate([y0, y0]), np.concatenate([x0, x0 + mbw])
            t2, i2, h2 = (np.concatenate([v, v]) for v in (t, i, h))
            for off in ((0,) if outer else (4,)):
                _plane_edge(UV, 8, y2, x2, off, across, t2, i2, h2, outer)


def _plane_edge(P, size, my, mx, off, across, limit, ilevel, hev, outer):
    """One edge of each of several macroblocks of a plane: the vertical
    edge ``off`` pixels into the macroblock (``across`` 1: filtered along
    the rows), or the horizontal one (0)."""
    ar, ar8 = np.arange(size), np.arange(8) - 4
    if across:
        rows = (size * my)[:, None, None] + ar[None, :, None]
        cols = (size * mx + off)[:, None, None] + ar8[None, None, :]
    else:
        rows = (size * my + off)[:, None, None] + ar8[None, None, :]
        cols = (size * mx)[:, None, None] + ar[None, :, None]
    _edge(P, rows, cols, limit, ilevel, hev, outer)


def _upsample(c: np.ndarray, w: int, h: int) -> np.ndarray:
    """libwebp's fancy upsampler (``UpsampleRgbLinePair``): a chroma plane
    ((h + 1) // 2, (w + 1) // 2) -> (h, w).  Each output takes its nearest
    sample A, the two next to it B (across) and C (down or up), and the
    diagonal one D: ((A + 3B + 3C + D + 8) >> 3 + A) >> 1; the first row
    and column (and the last, where h or w is even) are filtered along one
    axis only, (3A + C + 2) >> 2 or (3A + B + 2) >> 2."""
    ch, cw = c.shape
    r = np.arange(h)
    odd = r % 2 == 1
    near = np.where(odd, (r - 1) // 2, r // 2)
    far = np.where(odd, np.minimum((r + 1) // 2, ch - 1), np.maximum(r // 2 - 1, 0))
    N, F = c[near].astype(np.int64), c[far].astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        x = np.arange(1, pairs + 1)
        A, B, C, D = N[:, x - 1], N[:, x], F[:, x - 1], F[:, x]
        out[:, 2 * x - 1] = (((A + 3 * B + 3 * C + D + 8) >> 3) + A) >> 1
        out[:, 2 * x] = (((B + 3 * A + 3 * D + C + 8) >> 3) + B) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * N[:, pairs] + F[:, pairs] + 2) >> 2
    return out


def _yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YUVToB/G/R``: 16-bit coefficients applied as
    ``MultHi`` (>> 8), a 14-bit sum, >> 6 with clipping -> (h, w, 3)."""
    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def _vp8_decode(body: bytes, w: int, h: int) -> np.ndarray:
    """A VP8 key frame (everything from the chunk's body on) -> (h, w, 3)
    BGR uint8, as libwebp's default decode gives it."""
    first = _le24(body) >> 5
    buf = body[10:]
    if first > len(buf):
        raise _Fail
    br = _Bool(buf[:first])
    hdr = _frame_header(br)
    tokens = buf[first:]
    if not tokens:
        raise _Fail
    br.get(1)  # whether to keep the probabilities: no later frame to keep them for
    probs, skip_prob = _probabilities(br)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    seg, skip, is4, ymodes, uvmodes = _intra_modes(br, hdr, mbw, mbh, skip_prob)
    coef, nzs = _vp8_tokens(_Bool(tokens), probs, hdr["quant"], seg, skip, is4, mbw, mbh)
    coef = coef.astype(np.int16).astype(np.int64)  # libwebp keeps them in int16
    i16 = ~np.asarray(is4, bool)
    if i16.any():
        coef[i16, :16, 0] = _wht(coef[i16, 24]).astype(np.int16)
    nonzero = ((nzs[:, :24] > 1) | (coef[:, :24, 0] != 0)).any(axis=1)
    # libwebp's choice of transform: SSE2 for a Y block with coefficients
    # past the third, and for all four U (or V) blocks when one has an AC
    full = nzs[:, :24] > 3
    full[:, 16:20] = (nzs[:, 16:20] > 1).any(axis=1, keepdims=True)
    full[:, 20:24] = (nzs[:, 20:24] > 1).any(axis=1, keepdims=True)
    blocks = coef[:, :24].reshape(-1, 16)
    coded = np.flatnonzero(blocks.any(axis=1))  # the rest add nothing
    res = np.zeros((len(blocks), 4, 4), np.int64)
    res[coded] = _idct(blocks[coded], full.reshape(-1)[coded])
    res = res.reshape(-1, 24, 4, 4)
    Y, U, V = _predict_planes(mbw, mbh, is4, ymodes, uvmodes, res)
    if hdr["filter_level"]:
        UV = np.concatenate([U, V], axis=1)
        _loop_filter(Y, UV, mbw, mbh, _filter_strengths(hdr), seg, is4,
                     np.asarray(is4, bool) | nonzero)
        U, V = UV[:, :8 * mbw], UV[:, 8 * mbw:]
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return _yuv_to_bgr(Y[:h, :w], _upsample(U[:ch, :cw], w, h), _upsample(V[:ch, :cw], w, h))
