"""The port's Netpbm, PAM, PFM and BMP readers (``netpbm.py``, ``bmp.py``,
reached through ``png.imread_color``, ``png.imread_unchanged``,
``png.decode_color`` and ``png.decode_unchanged``) against cv2, which the
reference reads its images with.

cv2 writes its own forms (binary and ascii PBM/PGM/PPM, PAM, PFM, 8-bit
grey BMP as a palette, 24- and 32-bit BMP); ``testing.encode_pnm``,
``encode_pam``, ``encode_pfm`` and ``encode_bmp`` write the rest (odd
maxvals, comments, RLE4/RLE8 with end-of-line, delta and end-of-bitmap
escapes, 1/4-bit palettes, 16-bit bit fields, top-down rows, the 12-,
108- and 124-byte headers) and are themselves held to cv2 on their own
samples first.  Every read must equal ``cv2.imdecode`` / ``cv2.imread``
exactly, dtype and shape included, or be None where cv2's is.  Then the
JAX package's ``Image``, ``Scene``, ``DiffDope(cfg)``'s gt arrays,
``_load_texture`` and ``load_mesh`` (a PLY naming a BMP, a .glb
embedding one) on such files must give the port's arrays or outcome.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import png, testing  # noqa: E402
from diffdope_tpu_torch.testing import (  # noqa: E402
    encode_bmp,
    encode_pam,
    encode_pfm,
    encode_pnm,
)
from torch_scene import one_torch_thread  # noqa: E402, F401

VARIANTS = testing.image_variants()
OTHERS = sorted(k for k in VARIANTS if k.split("_")[0] in ("pnm", "pam", "pfm", "bmp"))


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(data: bytes, modes, tmp_path):
    """The port's reads of ``data`` against cv2's in each mode, from bytes
    (``cv2.imdecode``) and from a file (``cv2.imread``)."""
    buf = np.frombuffer(data, np.uint8)
    path = tmp_path / "a.img"
    path.write_bytes(data)
    if "unchanged" in modes:
        _same(png.decode_unchanged(data), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
        _same(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    if "color" in modes:
        rgb = lambda img: cv2.cvtColor(img, cv2.COLOR_BGR2RGB)  # noqa: E731
        _same(png.decode_color(data), rgb(cv2.imdecode(buf, cv2.IMREAD_COLOR)))
        _same(png.imread_color(path), rgb(cv2.imread(str(path), cv2.IMREAD_COLOR)))


@pytest.mark.parametrize("name", OTHERS)
def test_torch_netpbm_bmp_variant_matches_cv2(name, tmp_path):
    """Every PBM/PGM/PPM (ascii and binary, maxvals 1 to 65535, comments,
    values past the maxval, a CRLF after the header), PAM, PFM (both byte
    orders, scales other than 1, saturating colour) and BMP variant
    (``testing.image_variants``), in each cv2 mode."""
    data, modes = VARIANTS[name]
    _check(data, modes, tmp_path)


_BIN, _ASCII = [cv2.IMWRITE_PXM_BINARY, 1], [cv2.IMWRITE_PXM_BINARY, 0]


@pytest.mark.parametrize("ext,channels,dtype,flags", [
    (".pgm", 0, np.uint8, _BIN), (".pgm", 0, np.uint8, _ASCII),
    (".pgm", 0, np.uint16, _BIN), (".pgm", 0, np.uint16, _ASCII),
    (".ppm", 3, np.uint8, _BIN), (".ppm", 3, np.uint8, _ASCII),
    (".ppm", 3, np.uint16, _BIN), (".ppm", 3, np.uint16, _ASCII),
    (".pbm", 0, np.uint8, _BIN), (".pbm", 0, np.uint8, _ASCII),
    (".pam", 0, np.uint8, []), (".pam", 3, np.uint8, []),
    (".pfm", 0, np.float32, []), (".pfm", 3, np.float32, []),
    (".bmp", 0, np.uint8, []), (".bmp", 3, np.uint8, []), (".bmp", 4, np.uint8, [])])
def test_torch_cv2_written_files_match_cv2(tmp_path, ext, channels, dtype, flags):
    """cv2's own writes (a 16-bit or 4-channel PAM cv2 writes and cannot
    read back, so neither is here): read back as cv2 reads them."""
    img = testing.variant_image(21, 30, channels, dtype, 5)
    if ext == ".pbm":
        img = np.where(img > 127, 255, 0).astype(np.uint8)
    ok, enc = cv2.imencode(ext, img, flags)
    assert ok
    _same(cv2.imdecode(enc, cv2.IMREAD_UNCHANGED), img)
    modes = testing.UNCHANGED if ext == ".pfm" and not channels else testing.BOTH
    _check(enc.tobytes(), modes, tmp_path)


def test_torch_netpbm_writers_round_trip_through_cv2():
    """``encode_pnm``, ``encode_pam`` and ``encode_pfm`` read back by cv2:
    binary samples raw, ascii scaled by 255 / maxval at 8 bits, bitmaps
    inverted, PAM in the file's order, PFM as written (BGR)."""
    g8 = testing.variant_image(9, 14, 0, np.uint8, 1)
    c16 = testing.variant_image(9, 14, 3, np.uint16, 2)
    read = lambda d: cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_UNCHANGED)  # noqa
    _same(read(encode_pnm(g8, "P5")), g8)
    _same(read(encode_pnm(g8, "P2")), g8)
    _same(read(encode_pnm((g8 % 101).astype(np.uint8), "P5", 100)), (g8 % 101).astype(np.uint8))
    _same(read(encode_pnm((g8 % 101).astype(np.uint8), "P2", 100)),
          ((g8 % 101).astype(np.int64) * 255 // 100).astype(np.uint8))
    _same(read(encode_pnm(c16, "P6")), c16[..., ::-1])
    _same(read(encode_pnm(c16, "P3")), c16[..., ::-1])
    bits = (g8 > 100).astype(np.uint8)
    for magic in ("P1", "P4"):
        _same(read(encode_pnm(bits, magic)), ((1 - bits) * 255).astype(np.uint8))
    _same(read(encode_pam(c16, tupltype="RGB")), c16)
    f3 = testing.variant_image(9, 14, 3, np.float32, 3)
    for scale in (-1.0, 1.0):
        _same(read(encode_pfm(f3, scale)), f3[..., ::-1])
        _same(read(encode_pfm(f3[..., 0], scale)), f3[..., 0])


def test_torch_bmp_writer_round_trips_through_cv2():
    """``encode_bmp``'s palettes, RLE, bit fields, 24/32 bits, top-down
    rows and headers read back by cv2 as the samples they encode."""
    ix = testing.variant_image(11, 17, 0, np.uint8, 4)
    pal = np.random.default_rng(5).integers(0, 256, (256, 3)).astype(np.uint8)
    read = lambda d: cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR)  # noqa
    for header in (12, 40, 108, 124):
        for depth in (1, 4, 8):
            small = (ix.astype(np.int64) * (1 << depth) // 256).astype(np.uint8)
            _same(read(encode_bmp(small, depth, pal[: 1 << depth], header)),
                  pal[small][..., ::-1])
    rle = (ix % 4).astype(np.uint8)
    rle[:, 3:9] = 2
    for depth in (4, 8):
        for opts in ({}, {"eol_tail": True, "delta": True, "early_end": True}):
            _same(read(encode_bmp(rle, depth, pal[:16], rle=True, **opts)), pal[rle][..., ::-1])
    words = testing.variant_image(11, 17, 0, np.uint16, 6).astype(np.int64)
    want = np.stack([(words << 3) & 0xF8, (words >> 3) & 0xFC, (words >> 8) & 0xF8], -1)
    _same(read(encode_bmp(words, 16, masks=(0xF800, 0x7E0, 0x1F, 0), top_down=True)),
          want.astype(np.uint8))
    c8 = testing.variant_image(11, 17, 4, np.uint8, 7)
    _same(read(encode_bmp(c8[..., :3], 24)), c8[..., 2::-1])
    _same(cv2.imdecode(np.frombuffer(encode_bmp(c8, 32, header=124, masks=(
        0xFF0000, 0xFF00, 0xFF, 0xFF000000)), np.uint8), cv2.IMREAD_UNCHANGED),
        c8[..., [2, 1, 0, 3]])


@pytest.mark.parametrize("variant,data,modes", [
    ("BLACKANDWHITE", encode_pam(np.ones((4, 5), np.uint8), 1, "BLACKANDWHITE"),
     testing.BOTH),
    ("PAM with alpha under IMREAD_COLOR",
     encode_pam(np.ones((4, 5, 4), np.uint8), tupltype="RGB_ALPHA"), ("color",)),
    ("one-channel PFM under IMREAD_COLOR", encode_pfm(np.ones((4, 5), np.float32)),
     ("color",)),
    ("16-bit masks", encode_bmp(np.ones((4, 5), np.uint16), 16,
                                masks=(0xF00, 0xF0, 0xF, 0)), testing.BOTH),
])
def test_torch_netpbm_bmp_refused_variants_raise_by_name(tmp_path, variant, data, modes):
    """What the port does not decode raises ``ValueError`` naming it (and
    the file, read from one); a one-channel PFM read as colour from a file
    gives None, as ``cv2.imread`` does."""
    path = tmp_path / "v.img"
    path.write_bytes(data)
    readers = {"unchanged": (png.imread_unchanged, png.decode_unchanged),
               "color": (png.imread_color, png.decode_color)}
    for mode in modes:
        from_path, from_bytes = readers[mode]
        with pytest.raises(ValueError, match=variant):
            from_bytes(data)
        if variant.startswith("one-channel PFM"):
            assert from_path(path) is None
            assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
            continue
        with pytest.raises(ValueError, match=variant) as err:
            from_path(path)
        assert str(path) in str(err.value)


def _scene(tmp_path, h=48, w=64):
    """rgb as a 24-bit BMP and a binary PPM, seg as an 8-bit PGM and a
    palette BMP, depth as a 16-bit PGM (maxval 4000) and a PFM, from
    seeded smooth noise, all written by cv2."""
    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([np.sin(x / 7.0 + c) * np.cos(y / 5.0) * 0.4 + 0.5 for c in range(3)], -1)
    rgb = np.clip(np.round((rgb + rng.uniform(0, 0.05, (h, w, 3))) * 255), 0, 255)
    bgr = rgb.astype(np.uint8)[..., ::-1]
    seg = (((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2) * 255).astype(np.uint8)
    depth = np.round((2.5 + np.sin(x / 11.0) * 0.3) * 1000).astype(np.uint16)
    paths = {"rgb_bmp": tmp_path / "rgb.bmp", "rgb_ppm": tmp_path / "rgb.ppm",
             "seg_pgm": tmp_path / "seg.pgm", "seg_bmp": tmp_path / "seg.bmp",
             "depth_pgm": tmp_path / "depth.pgm", "depth_pfm": tmp_path / "depth.pfm"}
    for key, img in (("rgb_bmp", bgr), ("rgb_ppm", bgr), ("seg_pgm", seg), ("seg_bmp", seg),
                     ("depth_pgm", depth), ("depth_pfm", depth.astype(np.float32))):
        assert cv2.imwrite(str(paths[key]), img)
    return paths


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_scene_from_netpbm_bmp_matches_reference(tmp_path, resize):
    """``Image`` (rgb, depth, seg) and ``Scene`` from BMP, PPM, PGM and
    PFM files: the port's float32 arrays equal the reference's."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    paths = _scene(tmp_path)
    for key, path in paths.items():
        kw = dict(img_path=str(path), img_resize=resize, depth=key.startswith("depth"))
        _same(port.Image(**kw).img_tensor, ref.Image(**kw).img_tensor)
    for rgb, seg, depth in (("rgb_bmp", "seg_pgm", "depth_pgm"),
                            ("rgb_ppm", "seg_bmp", "depth_pfm")):
        args = dict(path_img=str(paths[rgb]), path_depth=str(paths[depth]),
                    path_segmentation=str(paths[seg]), image_resize=resize)
        got, want = port.Scene(**args).gt_arrays(), ref.Scene(**args).gt_arrays()
        assert set(got) == set(want) == {"rgb", "depth", "segmentation"}
        for key in want:
            _same(got[key], want[key])


def test_torch_pfm_as_colour_gives_reference_outcome(tmp_path):
    """A one-channel PFM read as colour: ``cv2.imread`` gives None, so both
    packages' ``Image`` and ``_load_texture`` raise ``FileNotFoundError``."""
    from diffdope_tpu.image import Image as RefImage
    from diffdope_tpu.mesh import _load_texture as ref_load_texture

    from diffdope_tpu_torch.image import Image
    from diffdope_tpu_torch.mesh import _load_texture

    path = tmp_path / "d.pfm"
    path.write_bytes(encode_pfm(testing.variant_image(16, 16, 0, np.float32, 2)))
    for image in (Image, RefImage):
        with pytest.raises(FileNotFoundError):
            image(img_path=str(path))
    for load in (_load_texture, ref_load_texture):
        with pytest.raises(FileNotFoundError):
            load(path)


@pytest.mark.parametrize("fmt", ["bmp", "ppm"])
def test_torch_bmp_ppm_textures_match_reference(tmp_path, fmt):
    """``_load_texture`` of a BMP (8-bit palette, RLE8) and of a PPM, a
    textured PLY naming it and a .glb embedding it, through both packages'
    ``load_mesh``: the textures are equal, the corner colours within 1e-6."""
    from pathlib import Path

    from diffdope_tpu.mesh import _load_texture as ref_load_texture
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    from diffdope_tpu_torch import mesh as port
    from diffdope_tpu_torch.mesh import load_ply

    if fmt == "bmp":
        ix = (testing.variant_image(64, 48, 0, np.uint8, 8) // 16).astype(np.uint8)
        pal = np.random.default_rng(9).integers(0, 256, (256, 3)).astype(np.uint8)
        data = encode_bmp(ix, 8, pal, rle=True, eol_tail=True)
    else:
        data = encode_pnm(testing.variant_image(64, 48, 3, np.uint8, 8), "P6")
    path = tmp_path / f"tex.{fmt}"
    path.write_bytes(data)
    _same(port._load_texture(path), ref_load_texture(path))
    src = Path(__file__).resolve().parent.parent / "data/standins/standin_tex_checker.ply"
    lines = [f"comment TextureFile tex.{fmt}".encode() if b"TextureFile" in ln else ln
             for ln in src.read_bytes().split(b"\n")]
    (tmp_path / "m.ply").write_bytes(b"\n".join(lines))
    ply_data = load_ply(src)
    testing.write_gltf(tmp_path / "m.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=data)
    for name in ("m.ply", "m.glb"):
        got = port.load_mesh(tmp_path / name, scale=0.01)
        want = ref_load_mesh(tmp_path / name, scale=0.01)
        _same(np.asarray(got.tex), np.asarray(want.tex))
        np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0, atol=1e-6)


def test_torch_diffdope_gt_from_netpbm_bmp_matches_reference(tmp_path):
    """``DiffDope(cfg)`` from a BMP rgb, a PGM seg and a PFM depth in both
    packages: the gt arrays are equal."""
    import copy

    import diffdope_tpu as dd
    from diffdope_tpu.mesh import save_ply
    from diffdope_tpu.testing import icosphere

    import diffdope_tpu_torch as tdd

    paths = _scene(tmp_path)
    verts, faces = icosphere(1)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    cfg = {
        "camera": {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "im_width": 64,
                   "im_height": 48},
        "scene": {"path_img": str(paths["rgb_bmp"]), "path_depth": str(paths["depth_pfm"]),
                  "path_segmentation": str(paths["seg_pgm"]), "image_resize": 0.5},
        "object3d": {"position": [0.0, 0.0, -3.0], "rotation": [0.0, 0.0, 0.0, 1.0],
                     "scale": 1.0, "model_path": str(ply)},
        "losses": {"l1_mask": True, "l1_rgb_with_mask": True, "l1_depth_with_mask": True},
        "hyperparameters": {"batchsize": 2, "nb_iterations": 1},
        "tpu": {"raster_impl": "reference", "progress": False},
    }
    ref = dd.DiffDope(cfg=dd.ConfigNode(copy.deepcopy(cfg)))
    port = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
    assert set(port.gt_tensors) == set(ref.gt_tensors) == {"rgb", "depth", "segmentation"}
    for key, value in ref.gt_tensors.items():
        _same(np.asarray(port.gt_tensors[key]), np.asarray(value))
