"""Write the JPEG-in-TIFF corpus that ``tests/test_torch_tiff.py``,
``tools/port_cv2_formats.py`` and ``chip_smoke.py`` hold the port's
TIFF reader to cv2 on: files written by Pillow's libtiff (RGB, YCbCr and
grey, in one strip and in several), by cv2's own TIFF writer, and
assembled from cv2's JPEG streams by ``testing.encode_jpeg_tiff`` (YCbCr
at 4:2:0, 4:2:2 and 4:4:4 in strips and tiles, with and without shared
JPEGTables, the orientation tag, grey, and two that libtiff refuses: RGB
with subsampled components, strips of differing subsampling), into
``tests/torch_data/tiff_jpeg/``.

    python tools/port_tiff_jpeg_corpus.py [OUT_DIR]

The files are committed: the card's host may lack Pillow, and another
libjpeg writes other bytes.  ``testing.tiff_jpeg_variants`` lists them.
"""

import io
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffdope_tpu_torch.testing import (  # noqa: E402
    encode_jpeg_tiff,
    encode_tiff,
    variant_image,
)

OUT = Path(__file__).resolve().parent.parent / "tests" / "torch_data" / "tiff_jpeg"


def jpeg(sampling=None, quality=90):
    """cv2's JPEG encoder on RGB or grey arrays: a JFIF stream."""
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]

    def encode(arr):
        img = np.ascontiguousarray(arr[..., ::-1]) if arr.ndim == 3 else arr
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        return buf.tobytes()
    return encode


def files():
    import cv2
    from PIL import Image

    rgb = variant_image(37, 45, 3, np.uint8, 2)
    grey = variant_image(37, 45, 0, np.uint8, 3)
    out = {}
    for mode, arr in (("RGB", rgb), ("YCbCr", rgb), ("L", grey)):
        for strip in (None, 1000):
            im = Image.fromarray(arr).convert(mode)
            buf = io.BytesIO()
            kw = {} if strip is None else {"strip_size": strip}
            im.save(buf, format="TIFF", compression="jpeg", **kw)
            out[f"pil_{mode.lower()}{'_strips' if strip else ''}"] = buf.getvalue()
    ok, buf = cv2.imencode(".tif", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    assert ok
    out["cv2_rgb"] = buf.tobytes()
    samplings = {"420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (2, 2)),
                 "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (2, 1)),
                 "444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, (1, 1))}
    for name, (factor, sub) in samplings.items():
        enc = jpeg(factor)
        out[f"ycc{name}_one_strip"] = encode_jpeg_tiff(rgb, enc, subsampling=sub,
                                                       shared_tables=False)
        out[f"ycc{name}_strips"] = encode_jpeg_tiff(rgb, enc, rows_per_strip=16,
                                                    subsampling=sub)
        out[f"ycc{name}_strips_own_tables"] = encode_jpeg_tiff(
            rgb, enc, rows_per_strip=8, subsampling=sub, shared_tables=False, big_endian=True)
        out[f"ycc{name}_tiles"] = encode_jpeg_tiff(rgb, enc, tile=(16, 16), subsampling=sub)
    enc = jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    for o in (3, 6):
        out[f"ycc420_orient{o}"] = encode_jpeg_tiff(rgb, enc, rows_per_strip=16, orientation=o)
        out[f"ycc420_tiles_orient{o}"] = encode_jpeg_tiff(rgb, enc, tile=(32, 16),
                                                          orientation=o)
    out["ycc420_q50"] = encode_jpeg_tiff(rgb, jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 50),
                                         rows_per_strip=24)
    out["grey_strips"] = encode_jpeg_tiff(grey, jpeg(), rows_per_strip=16, photometric=1)
    out["grey_tiles"] = encode_jpeg_tiff(grey, jpeg(), tile=(16, 32), photometric=1)
    out["rgb_444_strips"] = encode_jpeg_tiff(rgb, jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                                             rows_per_strip=16, photometric=2)
    # libtiff refuses these (cv2 reads no image): RGB whose stream is
    # subsampled, strips whose subsampling differs from the first one's
    out["rgb_420_refused"] = encode_jpeg_tiff(
        rgb, jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420), rows_per_strip=16, photometric=2)
    mixed = [enc(rgb[:16]), jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)(rgb[16:32]),
             enc(rgb[32:])]
    out["ycc_mixed_sampling_refused"] = encode_tiff(
        rgb, photometric=6, compression=7, rows_per_strip=16, coded=mixed,
        tags=[(530, 3, [2, 2])])
    return out


def main(argv):
    out_dir = Path(argv[0]) if argv else OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.tif"):
        old.unlink()
    for name, data in files().items():
        (out_dir / f"{name}.tif").write_bytes(data)
        print(f"{name}.tif: {len(data)} bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
