"""Write the OpenEXR corpus that ``tests/test_torch_exr.py``,
``tools/port_cv2_formats.py`` and ``chip_smoke.py`` hold the port's EXR
reader to cv2 4.13 on, into ``tests/torch_data/exr/``:

- ``cv2_<compression>_<half|float>_c<channels>.exr``: cv2's own writer
  (``cv2.imwrite`` with ``IMWRITE_EXR_COMPRESSION`` and
  ``IMWRITE_EXR_TYPE``) at every compression OpenEXR 2.3 codes, half and
  float samples, 1 (Y), 3 (B, G, R) and 4 (with A) channels, at sizes
  past PIZ's and B44's 32-line blocks and, for one channel, DWAB's 256;
  written with ``--cv2`` on a host whose cv2 writes OpenEXR (the card's
  host, cv2 4.13.0 over OpenEXR 2.3.0: the tests' cv2 5.0 has no
  OpenEXR codec);
- ``np_*.exr``: ``testing.encode_exr``, the structures cv2 does not
  write: tiles (one level, mip and rip levels, rounding down and up,
  partial tiles), decreasing and random line orders, data windows off
  the origin and unlike the display window, UINT and mixed sample types,
  single channels named other than Y (Z, a render layer's depth), extra
  channels, luminance/chroma (RY, BY, subsampled), names past 31 bytes,
  PXR24 on every type (no luminance/chroma off the origin: cv2 4.13
  segfaults on it), DWAA/DWAB (``testing.encode_exr``'s DWA writer:
  the default channel rules with lossy DCT, CSC sets, RLE alpha and
  UNKNOWN channels, Huffman- and zlib-coded AC, perceptually linear
  channels, tiles), multi-part, deep and truncated files.

    python tools/port_exr_corpus.py [--cv2] [OUT_DIR]

Without ``--cv2`` only the ``np_*`` files are (re)written; with it only
the ``cv2_*`` ones.  The files are committed; ``testing.exr_variants``
lists them.
"""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffdope_tpu_torch.testing import (  # noqa: E402
    EXR_COMPRESSIONS,
    EXR_CORPUS,
    EXR_FLOAT,
    EXR_HALF,
    EXR_UINT,
    encode_exr,
    exr_content,
)

#: (rows, columns) of cv2's files by channel count: one channel past
#: DWAB's 256-line blocks, the others past the 32-line ones
CV2_SIZES = {1: (301, 9), 3: (45, 37), 4: (35, 21)}


def cv2_files():
    """cv2's own EXR files: every compression x half/float x 1/3/4
    channels, of ``exr_content``."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    out = {}
    for comp, name in enumerate(EXR_COMPRESSIONS):
        for kind, tag in ((cv2.IMWRITE_EXR_TYPE_HALF, "half"),
                          (cv2.IMWRITE_EXR_TYPE_FLOAT, "float")):
            for ch, (h, w) in CV2_SIZES.items():
                img = exr_content(h, w, ch, seed=comp * 10 + ch)
                img = img[..., 0] if ch == 1 else img
                ok, buf = cv2.imencode(".exr", img, [cv2.IMWRITE_EXR_COMPRESSION, comp,
                                                     cv2.IMWRITE_EXR_TYPE, kind])
                if not ok:
                    raise RuntimeError(f"cv2 {cv2.__version__} wrote no {name} {tag} EXR")
                out[f"cv2_{name}_{tag}_c{ch}"] = buf.tobytes()
    return out


def numpy_files():
    """``testing.encode_exr``'s files of the structures cv2 does not write."""
    out = {}
    c3 = exr_content(37, 23, 3, seed=101)
    c4 = exr_content(41, 27, 4, seed=102)
    z = exr_content(43, 29, 1, seed=103)[..., 0]
    rgb = {"R": c3[..., 0], "G": c3[..., 1], "B": c3[..., 2]}
    rgba = {"R": c4[..., 0], "G": c4[..., 1], "B": c4[..., 2], "A": c4[..., 3]}
    f32 = dict.fromkeys("RGBAYZ", EXR_FLOAT)
    u = np.abs(exr_content(35, 19, 3, seed=104)).astype(np.float64)
    u = np.nan_to_num(u, posinf=1e9, neginf=0.0) * 3e7
    u[0, :4, 0] = [0, 1, 2 ** 24 + 1, 2 ** 32 - 1]
    uint = {k: u[..., i] for i, k in enumerate("RGB")}
    blue = np.abs(np.nan_to_num(c4[..., 2], posinf=7.0, neginf=0.0))
    # ---- single channels named otherwise, extra channels
    out["np_z_float_zip"] = encode_exr({"Z": z}, 3, types={"Z": EXR_FLOAT})
    out["np_z_half_none"] = encode_exr({"Z": z}, 0)
    out["np_viewlayer_depth_z_float"] = encode_exr({"ViewLayer.Depth.Z": z}, 2,
                                                   types={"ViewLayer.Depth.Z": EXR_FLOAT})
    long_name = "RenderLayer.CompositingPass.Depth.Z"
    out["np_long_name_depth"] = encode_exr({long_name: z}, 3, types={long_name: EXR_FLOAT},
                                           long_names=True)
    steps = np.round(np.nan_to_num(z, posinf=9.0, neginf=-9.0) * 8) / 8  # runs for the run-length coder
    out["np_y_float_rle"] = encode_exr({"Y": steps}, 1, types=f32)
    out["np_y_a_half_zips"] = encode_exr({"Y": c3[..., 0], "A": c3[..., 1]}, 2)
    out["np_a_only"] = encode_exr({"A": z}, 0)
    out["np_r_only"] = encode_exr({"R": z}, 3)
    out["np_g_only_float"] = encode_exr({"G": z}, 0, types=f32)
    out["np_r_b"] = encode_exr({"R": c3[..., 0], "B": c3[..., 2]}, 2)
    out["np_rgb_z_extra"] = encode_exr({**rgb, "Z": c3[..., 1] * 5}, 3,
                                       types={"Z": EXR_FLOAT})
    out["np_rgba_extras"] = encode_exr({**rgba, "depth.Z": c4[..., 0] * 9,
                                        "normal.X": c4[..., 1]}, 0)
    out["np_xyz_channels"] = encode_exr({"X": c3[..., 0], "Y": c3[..., 1], "Z": c3[..., 2]}, 3)
    out["np_lowercase_rgb"] = encode_exr({"r": c3[..., 0], "g": c3[..., 1], "b": c3[..., 2]}, 0)
    out["np_two_named"] = encode_exr({"depth": z, "mask": (z > 0.5).astype(np.float32)}, 3,
                                     types={"depth": EXR_FLOAT})
    # ---- sample types
    out["np_uint_rgb_zips"] = encode_exr(uint, 2, types=dict.fromkeys("RGB", EXR_UINT))
    out["np_uint_y_rle"] = encode_exr({"Y": uint["R"] // 2 ** 26}, 1, types={"Y": EXR_UINT})
    out["np_uint_z_none"] = encode_exr({"Z": uint["G"]}, 0, types={"Z": EXR_UINT})
    out["np_mixed_types_zip"] = encode_exr(
        {"R": c4[..., 0], "G": c4[..., 1], "B": blue * 1000,
         "A": c4[..., 3]}, 3, types={"R": EXR_HALF, "G": EXR_FLOAT, "B": EXR_UINT,
                                     "A": EXR_HALF})
    # ---- PXR24 on every type (cv2 writes it on half and float only)
    out["np_pxr24_mixed"] = encode_exr(
        {"R": c4[..., 0], "G": c4[..., 1], "B": blue * 1e6,
         "A": c4[..., 3]}, 5, types={"R": EXR_FLOAT, "G": EXR_HALF, "B": EXR_UINT,
                                     "A": EXR_FLOAT})
    out["np_pxr24_z_float"] = encode_exr({"Z": z}, 5, types={"Z": EXR_FLOAT})
    # ---- luminance / chroma
    yc = exr_content(38, 26, 3, seed=105)
    half = {"RY": yc[::2, ::2, 1] * 0.2, "BY": yc[::2, ::2, 2] * 0.2}
    sub = {"RY": (2, 2), "BY": (2, 2)}
    out["np_yc_420_zip"] = encode_exr({"Y": yc[..., 0], **half}, 3, sampling=sub)
    out["np_yca_420_none"] = encode_exr({"Y": yc[..., 0], "A": yc[..., 1], **half}, 0,
                                        sampling=sub)
    out["np_yc_444_float"] = encode_exr({"Y": yc[..., 0], "RY": yc[..., 1] * 0.2,
                                         "BY": yc[..., 2] * 0.2}, 2, types=dict.fromkeys(
                                             ("Y", "RY", "BY"), EXR_FLOAT))
    out["np_y_ry_only"] = encode_exr({"Y": yc[..., 0], "RY": yc[..., 1] * 0.2}, 0)
    chroma = np.array([0.7, 0.3, 0.2, 0.7, 0.1, 0.05, 0.3, 0.33], np.float32).tobytes()
    out["np_yc_chromaticities"] = encode_exr({"Y": yc[..., 0], **half}, 3, sampling=sub,
                                             attrs=[("chromaticities", "chromaticities",
                                                     chroma)])
    out["np_rgb_chromaticities"] = encode_exr(rgb, 3, attrs=[("chromaticities",
                                                              "chromaticities", chroma)])
    out["np_y_subsampled_x"] = encode_exr({"Y": yc[:, ::2, 0]}, 0, sampling={"Y": (2, 1)})
    # ---- line orders and windows
    out["np_decreasing_zip"] = encode_exr(rgba, 3, line_order=1)
    out["np_decreasing_none"] = encode_exr(rgb, 0, line_order=1, types=f32)
    out["np_offset_window_zip"] = encode_exr(rgb, 3, origin=(-7, 13), display=(0, 0, 19, 39))
    out["np_display_larger"] = encode_exr({"Z": z}, 2, types={"Z": EXR_FLOAT},
                                          origin=(3, 5), display=(0, 0, 63, 63))
    # ---- tiles
    out["np_tiled_zip"] = encode_exr(rgb, 3, tile=(16, 8, 0, 0))
    out["np_tiled_none_float"] = encode_exr(rgba, 0, types=f32, tile=(8, 8, 0, 0))
    out["np_tiled_mip_down_rle"] = encode_exr({k: np.round(v * 4) / 4 for k, v in rgb.items()},
                                              1, tile=(8, 8, 1, 0))
    out["np_tiled_mip_up_zips"] = encode_exr({"Z": z}, 2, types={"Z": EXR_FLOAT},
                                             tile=(16, 16, 1, 1))
    out["np_tiled_rip_down_pxr24"] = encode_exr(rgb, 5, tile=(8, 16, 2, 0))
    out["np_tiled_rip_up_none"] = encode_exr({"Y": z}, 0, tile=(4, 4, 2, 1))
    out["np_tiled_decreasing_zip"] = encode_exr(rgba, 3, line_order=1, tile=(8, 8, 0, 0))
    out["np_tiled_random_zips"] = encode_exr(rgb, 2, line_order=2, tile=(8, 8, 1, 0))
    out["np_tiled_offset_window"] = encode_exr(rgb, 3, origin=(-5, 9), tile=(16, 16, 0, 0))
    out["np_tiled_uint"] = encode_exr(uint, 3, types=dict.fromkeys("RGB", EXR_UINT),
                                      tile=(16, 8, 0, 0))
    # ---- taller than DWAB's blocks, on every lossless coder of this writer
    tall = exr_content(300, 11, 1, seed=106)[..., 0]
    for comp in (0, 1, 2, 3, 5):
        out[f"np_tall_{EXR_COMPRESSIONS[comp]}"] = encode_exr(
            {"Z": np.round(tall * 64) / 64 if comp in (1, 2) else tall}, comp,
            types={"Z": EXR_FLOAT})
    # ---- DWAA / DWAB (cv2 4.13's own writer emits them without data)
    d4 = np.clip(np.nan_to_num(c4, nan=0.5, posinf=1.0, neginf=0.0), -0.5, 1.5)
    d4[:16, :16] = 0.25  # constant blocks
    d4[20:28, :8, 1] = 0.75  # a block whose Cb alone has AC
    drgba = {k: d4[..., i] for i, k in enumerate("RGBA")}
    yy, xx = np.mgrid[0:41, 0:27]
    smooth = (0.5 + 0.4 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.float32)
    smooth[:16, :8] = 0.25
    tall3 = np.clip(exr_content(300, 19, 3, seed=107), -0.5, 1.5)
    tall3 = np.nan_to_num(tall3, nan=0.5, posinf=1.0, neginf=0.0)
    out["np_dwaa_unknown_y_half"] = encode_exr({"Y": steps[:, :23]}, 8, dwa={"rules": ()})
    out["np_dwab_unknown_rgb_float"] = encode_exr(
        {k: np.round(d4[..., i] * 16) / 16 for i, k in enumerate("RGB")}, 9,
        types=dict.fromkeys("RGB", EXR_FLOAT), dwa={"rules": ()})
    out["np_dwaa_rgba_half"] = encode_exr(drgba, 8)
    out["np_dwaa_rgba_half_deflate"] = encode_exr(drgba, 8, dwa={"ac": "deflate"})
    out["np_dwab_rgb_half_tall"] = encode_exr({k: tall3[..., i] for i, k in enumerate("RGB")},
                                              9)
    out["np_dwaa_y_half"] = encode_exr({"Y": smooth}, 8)
    out["np_dwaa_y_half_linear"] = encode_exr({"Y": smooth}, 8, linear=("Y",))
    out["np_dwaa_rgb_half_linear"] = encode_exr({k: d4[..., i] for i, k in enumerate("RGB")},
                                                8, linear=("R", "G", "B"))
    out["np_dwaa_rgb_float"] = encode_exr({k: d4[..., i] for i, k in enumerate("RGB")}, 8,
                                          types=dict.fromkeys("RGB", EXR_FLOAT))
    out["np_dwaa_yc_half"] = encode_exr({"Y": d4[..., 0], "RY": d4[..., 1] * 0.2,
                                         "BY": d4[..., 2] * 0.2}, 8)
    out["np_dwaa_two_layers"] = encode_exr(
        {**{k: d4[..., i] for i, k in enumerate("RGB")},
         **{f"diffuse.{k}": d4[..., 2 - i] for i, k in enumerate("RGB")}, "Z": z[:41, :27]},
        8, types={"Z": EXR_FLOAT})
    out["np_dwaa_mixed_types"] = encode_exr({k: d4[..., i] for i, k in enumerate("RGBA")}, 8,
                                            types={"B": EXR_FLOAT, "A": EXR_UINT})
    out["np_dwab_tiled"] = encode_exr({"R": smooth, "G": smooth * 0.5, "B": 1 - smooth,
                                       "A": d4[..., 3]}, 9, tile=(16, 16, 0, 0))
    out["np_dwaa_z_float"] = encode_exr({"Z": z}, 8, types={"Z": EXR_FLOAT})
    # ---- multi-part, deep, truncated
    first = dict(channels=rgb, compression=3, name="beauty")
    second = dict(channels={"Z": z}, compression=2, types={"Z": EXR_FLOAT}, name="depth",
                  tile=(16, 16, 0, 0))
    out["np_multipart_scanline_first"] = encode_exr({}, parts=[first, second])
    out["np_multipart_tiled_first"] = encode_exr({}, parts=[second, first])
    out["np_multipart_one_part"] = encode_exr({}, parts=[first])
    out["np_deep_scanline"] = encode_exr({"Z": z, "A": np.ones_like(z)}, 0,
                                         types={"Z": EXR_FLOAT}, deep=True)
    whole = encode_exr(rgb, 3)
    out["np_truncated_header"] = b"v/1\x01\x02\x00\x00\x00" + b"\0" * 64
    out["np_truncated_offsets"] = whole[:whole.index(b"\0\0", 300) + 12]
    out["np_truncated_data"] = whole[:len(whole) - 200]
    out["np_truncated_last_byte"] = whole[:-1]
    tiled = out["np_tiled_zip"]
    out["np_truncated_tiles"] = tiled[:len(tiled) * 2 // 3]
    out["np_version_1"] = b"v/1\x01\x01" + whole[5:]
    out["np_unknown_flags"] = whole[:5] + b"\x40" + whole[6:]
    return out


def main(argv):
    use_cv2 = "--cv2" in argv
    args = [a for a in argv if not a.startswith("--")]
    out_dir = Path(args[0]) if args else EXR_CORPUS
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = "cv2_" if use_cv2 else "np_"
    for old in out_dir.glob(f"{prefix}*.exr"):
        old.unlink()
    files = cv2_files() if use_cv2 else numpy_files()
    for name, data in files.items():
        (out_dir / f"{name}.exr").write_bytes(data)
    print(f"{len(files)} files, {sum(map(len, files.values()))} bytes in {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
