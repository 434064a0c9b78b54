"""The port's OpenEXR reader (``diffdope_tpu_torch/exr.py``, reached
through ``png.imread_color``, ``png.imread_unchanged``, ``png.decode_color``
and ``png.decode_unchanged``) against cv2 4.13, which the reference reads
its images with on the card's host.

The CPU tests' cv2 5.0 has no OpenEXR codec, so the yardstick is the
committed record ``tests/torch_data/exr_cv2.json``: cv2 4.13.0's reads
(dtype, shape, SHA-1) of every file of the corpus ``tests/torch_data/
exr/`` (``testing.exr_variants``: cv2's own files at every compression,
half and float, 1/3/4 channels; ``testing.encode_exr``'s tiles, levels,
line orders, windows, sample types, channel layouts, chroma, DWAA/DWAB,
multi-part, deep and truncated files), with ``OPENCV_IO_ENABLE_OPENEXR`` set and
unset, from bytes and from a file, in both modes
(``tools/port_cv2_formats.py --record-exr``).  Every port read must equal
the record bit for bit (None where cv2's is, raising where cv2 raised);
the deep scanline file, which cv2 composites, is refused by name.  Then
the port's ``Image`` and ``DiffDope`` from float EXR depth and colour are
held to the JAX package's from the same values as float32 TIFF (depth)
and PNG (cv2's uint8 of the colour), which this cv2 reads.
"""

import copy
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import exr, png, testing  # noqa: E402
from diffdope_tpu_torch.testing import EXR_FLOAT, encode_exr  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

RECORD = json.loads((Path(__file__).resolve().parent / "torch_data" / "exr_cv2.json")
                    .read_text())
VARIANTS = testing.exr_variants()
#: cv2 reads these (a deep scanline file's composite), the port refuses them
REFUSED = {"exr_np_deep_scanline": "OpenEXR deep data"}
CASES = [(name, mode, how) for name in sorted(VARIANTS) for mode in ("unchanged", "color")
         for how in ("decode", "read")]


@pytest.fixture
def gate(monkeypatch):
    monkeypatch.setenv(exr.GATE, "1")


def _summary(img):
    if img is None:
        return None
    return [img.dtype.name, list(img.shape), hashlib.sha1(img.tobytes()).hexdigest()[:12]]


def _port(data: bytes, mode: str, how: str, tmp_path):
    """The port's read as cv2 returns it (BGR for colour)."""
    if how == "read":
        path = tmp_path / "variant"
        path.write_bytes(data)
        got = (png.imread_unchanged if mode == "unchanged" else png.imread_color)(path)
    else:
        got = (png.decode_unchanged if mode == "unchanged" else png.decode_color)(data)
    if mode == "color" and got is not None:
        got = np.ascontiguousarray(got[..., ::-1])
    return got


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_torch_exr_corpus_is_the_recorded_one():
    """The corpus is the one cv2 4.13 read: the same names and bytes."""
    assert RECORD["cv2"] == "4.13.0" and "2.3.0" in RECORD["openexr"]
    assert set(VARIANTS) == set(RECORD["variants"])
    for name, (data, _) in VARIANTS.items():
        assert hashlib.sha1(data).hexdigest() == RECORD["variants"][name]["sha1"], name


@pytest.mark.parametrize("name,mode,how", CASES)
def test_torch_exr_variant_matches_cv2_4_13(name, mode, how, gate, tmp_path):
    """Every corpus file, in both modes, from bytes (``cv2.imdecode``) and
    from a file (``cv2.imread``), with the codec enabled: the port's read
    equals cv2 4.13's recorded one bit for bit (dtype, shape and SHA-1),
    None where cv2's is (truncated files, version 1, unknown flags,
    multi-part files of two parts, channels cv2 does not take, the DWA
    files cv2 4.13 writes without data).  The DWAA/DWAB files of
    ``testing.encode_exr`` hold cv2's inverse DCT (OpenEXR's SSE2 one),
    Y'CbCr and ``toLinear`` table to the last bit."""
    data, _ = VARIANTS[name]
    row = RECORD["variants"][name]
    want = row.get(f"{mode}_imread", row[mode]) if how == "read" else row[mode]
    if name in REFUSED:
        assert want is not None  # cv2 reads it
        with pytest.raises(ValueError, match=REFUSED[name]) as err:
            _port(data, mode, how, tmp_path)
        if how == "read":
            assert str(tmp_path / "variant") in str(err.value)
        return
    assert _summary(_port(data, mode, how, tmp_path)) == want


@pytest.mark.parametrize("value", [g["value"] for g in RECORD["gate"]])
def test_torch_exr_gate_as_cv2_4_13(value, monkeypatch, tmp_path):
    """``OPENCV_IO_ENABLE_OPENEXR`` as cv2 4.13 was recorded to take it: 1
    and true (three spellings) read, unset, 0, false and any other value
    raise on every read, bytes or file, both modes (cv2 raises
    ``cv2.error``; the port ``exr.CodecDisabled``, a ``ValueError`` naming
    the variable); the record's reads with the gate unset are all
    "raised"."""
    if value is None:
        monkeypatch.delenv(exr.GATE, raising=False)
    else:
        monkeypatch.setenv(exr.GATE, value)
    reads = next(g["cv2_reads"] for g in RECORD["gate"] if g["value"] == value)
    data, _ = VARIANTS["exr_cv2_zip_float_c3"]
    for mode in ("unchanged", "color"):
        for how in ("decode", "read"):
            if reads == "reads":
                assert _port(data, mode, how, tmp_path) is not None
            else:
                with pytest.raises(exr.CodecDisabled, match=exr.GATE):
                    _port(data, mode, how, tmp_path)
    if value is None:
        assert all(r["gate_unset"] == {"unchanged": "raised", "color": "raised"}
                   for r in RECORD["variants"].values())


def test_torch_exr_truncated_header_as_cv2_4_13(gate, tmp_path):
    """A bare OpenEXR header (magic, version 2, zeros): cv2 4.13 reads no
    image from it, so the port gives None in both modes, and names the
    format by its signature."""
    data = VARIANTS["exr_np_truncated_header"][0]
    assert data == b"v/1\x01\x02\x00\x00\x00" + b"\0" * 64
    assert RECORD["variants"]["exr_np_truncated_header"]["unchanged"] is None
    assert RECORD["variants"]["exr_np_truncated_header"]["color"] is None
    path = tmp_path / "x.img"
    path.write_bytes(data)
    for read in (png.imread_color, png.imread_unchanged):
        assert read(path) is None
    assert png.format_name(data) == "OpenEXR"


@pytest.mark.parametrize("variant", ["dwa_version_1", "b44_linear"])
def test_torch_exr_refused_variants_raise_by_name(variant, gate, tmp_path):
    """DWA blocks of version 1 (the legacy channel rules, before OpenEXR
    2.2) and B44 on a channel stored perceptually linear raise
    ``ValueError`` naming the variant, the format and the file."""
    if variant == "b44_linear":
        data = bytearray(VARIANTS["exr_cv2_b44_half_c3"][0])
        at = data.index(b"B\x00\x01\x00\x00\x00") + 6
        data[at] = 1  # pLinear of channel B
        match = "B44 on the perceptually linear"
    else:
        data = bytearray(VARIANTS["exr_np_dwaa_rgba_half"][0])
        _, table_at = exr._attributes(bytes(data), 8, 31)
        (chunk,) = struct.unpack_from("<q", data, table_at)
        assert struct.unpack_from("<q", data, chunk + 8)[0] == 2  # the first block's version
        data[chunk + 8] = 1
        match = "DWA version 1"
    path = tmp_path / "x.exr"
    path.write_bytes(bytes(data))
    for read in (png.imread_color, png.imread_unchanged):
        with pytest.raises(ValueError, match=match) as err:
            read(path)
        assert str(path) in str(err.value) and "format: OpenEXR" in str(err.value)


def test_torch_exr_writer_round_trips_through_the_reader(gate):
    """``testing.encode_exr`` and the port's reader agree on the channels
    of every lossless coding, scanline and tiled, on every sample type:
    a writer bug and a reader bug cannot cancel out only where cv2 4.13's
    record also agrees (the corpus test)."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=(37, 23)).astype(np.float32)
    for comp in (0, 1, 2, 3):
        for tile in (None, (8, 16, 0, 0), (16, 8, 1, 1)):
            for kind in (0, 1, 2):
                vals = np.abs(y) * 1e5 if kind == 0 else y
                data = encode_exr({"Y": vals}, comp, types={"Y": kind}, tile=tile)
                want = vals.astype(np.uint32 if kind == 0 else np.float16 if kind == 1
                                   else np.float32).astype(np.float32)
                _same(exr.decode_unchanged(data), want)


def _depth_and_colour(h, w):
    y, x = np.mgrid[0:h, 0:w]
    depth = (2500 + 30 * np.sin(x / 9.0) + 20 * np.cos(y / 7.0)).astype(np.float32)
    depth += np.float32(1 / 3)  # not an integer: the float path carries it
    rgb = np.stack([128 + 100 * np.sin(x / 9.0 + c) * np.cos(y / 7.0) for c in range(3)], -1)
    rgb = (rgb + np.random.default_rng(3).normal(0, 3, rgb.shape)).astype(np.float32)
    return depth, rgb


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_image_from_exr_matches_reference(tmp_path, resize, gate):
    """The port's ``Image(depth=True)`` of a float32 EXR depth (ZIP) equals
    the JAX package's ``Image(depth=True)`` of the same array as a float32
    TIFF, and the port's colour ``Image`` of a float32 RGB EXR equals the
    JAX package's of a PNG of cv2 4.13's uint8 read of it (its values
    rounded), bit for bit, flipped, at resize 1.0 and 0.5."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    depth, rgb = _depth_and_colour(48, 64)
    d_exr, d_tif = tmp_path / "depth.exr", tmp_path / "depth.tif"
    d_exr.write_bytes(encode_exr({"Y": depth}, 3, types={"Y": EXR_FLOAT}))
    assert cv2.imwrite(str(d_tif), depth)
    c_exr, c_png = tmp_path / "rgb.exr", tmp_path / "rgb.png"
    c_exr.write_bytes(encode_exr({"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]}, 2,
                                 types=dict.fromkeys("RGB", EXR_FLOAT)))
    assert cv2.imwrite(str(c_png), np.clip(np.rint(rgb), 0, 255).astype(np.uint8)[..., ::-1])
    for kw_port, kw_ref in ((dict(img_path=str(d_exr), depth=True),
                             dict(img_path=str(d_tif), depth=True)),
                            (dict(img_path=str(c_exr)), dict(img_path=str(c_png)))):
        got = port.Image(img_resize=resize, **kw_port).img_tensor
        _same(got, ref.Image(img_resize=resize, **kw_ref).img_tensor)
    assert port.Image(img_path=str(d_exr), depth=True).img_tensor.dtype == np.float32


def test_torch_image_from_exr_without_gate_raises(tmp_path, monkeypatch):
    """Without ``OPENCV_IO_ENABLE_OPENEXR`` the reference's ``cv2.imread``
    raises on an EXR on the card's host; the port's ``Image`` raises too
    (``exr.CodecDisabled``), and a truncated EXR read with the gate set
    gives ``FileNotFoundError``, as the reference's None does."""
    import diffdope_tpu_torch.image as port

    depth, _ = _depth_and_colour(8, 8)
    path = tmp_path / "depth.exr"
    path.write_bytes(encode_exr({"Y": depth}, 3, types={"Y": EXR_FLOAT}))
    monkeypatch.delenv(exr.GATE, raising=False)
    with pytest.raises(exr.CodecDisabled):
        port.Image(img_path=str(path), depth=True)
    monkeypatch.setenv(exr.GATE, "1")
    path.write_bytes(path.read_bytes()[:-3])
    with pytest.raises(FileNotFoundError):
        port.Image(img_path=str(path), depth=True)


def test_torch_diffdope_from_exr_depth_equals_tiff(tmp_path, gate):
    """A CPU ``DiffDope`` (rgb + mask + depth, 3 SGD steps) from a float32
    EXR depth (PIZ-free: ZIP) runs exactly as from the same depth as a
    float32 TIFF: gt arrays, loss history, argmin and pose, bit for
    bit."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import icosphere

    h, w = 48, 64
    depth, rgb = _depth_and_colour(h, w)
    y, x = np.mgrid[0:h, 0:w]
    inside = ((x - 30) ** 2 + (y - 24) ** 2) < 200
    rgb_path, seg_path = tmp_path / "rgb.png", tmp_path / "seg.png"
    assert cv2.imwrite(str(rgb_path), np.clip(rgb, 0, 255).astype(np.uint8))
    assert cv2.imwrite(str(seg_path), inside.astype(np.uint8) * 255)
    depths = {"exr": tmp_path / "depth.exr", "tif": tmp_path / "depth.tif"}
    depths["exr"].write_bytes(encode_exr({"Y": depth}, 3, types={"Y": EXR_FLOAT}))
    assert cv2.imwrite(str(depths["tif"]), depth)
    verts, faces = icosphere(1)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    runs = {}
    for kind, depth_path in depths.items():
        cfg = {
            "camera": {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "im_width": w,
                       "im_height": h},
            "scene": {"path_img": str(rgb_path), "path_depth": str(depth_path),
                      "path_segmentation": str(seg_path), "image_resize": 1.0},
            "object3d": {"position": [0.02, -0.01, 3.0], "rotation": [0.01, 0.0, 0.0, 1.0],
                         "scale": 1.0, "model_path": str(ply)},
            "losses": {"l1_mask": True, "l1_rgb_with_mask": True, "l1_depth_with_mask": True},
            "hyperparameters": {"batchsize": 2, "nb_iterations": 3},
            "tpu": {"raster_impl": "reference", "progress": False},
        }
        dd = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
        dd.run_optimization()
        runs[kind] = dd
    a, b = runs["tif"], runs["exr"]
    assert set(a.gt_tensors) == set(b.gt_tensors) == {"rgb", "depth", "segmentation"}
    for key in a.gt_tensors:
        _same(np.asarray(b.gt_tensors[key]), np.asarray(a.gt_tensors[key]))
    assert set(a.losses_values) == set(b.losses_values)
    for key in a.losses_values:
        _same(np.asarray(b.losses_values[key]), np.asarray(a.losses_values[key]))
    assert a.get_argmin() == b.get_argmin()
    _same(np.asarray(b.get_pose()), np.asarray(a.get_pose()))


def test_torch_exr_texture_and_gltf_image(tmp_path, gate):
    """A PLY naming an EXR texture and a .glb embedding it: the port's
    texture is cv2 4.13's uint8 read of the file / 255 (the record's
    conversion: rounded half to even, saturated), and the same through
    ``mesh.load_mesh`` of both; no EXR raises ``NotImplementedError``."""
    from diffdope_tpu_torch import mesh as port
    from diffdope_tpu_torch.mesh import load_ply

    _, rgb = _depth_and_colour(64, 48)
    data = encode_exr({"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]}, 3,
                      types=dict.fromkeys("RGB", EXR_FLOAT))
    want = np.clip(np.rint(rgb), 0, 255).astype(np.float32) / 255.0
    src = Path(__file__).resolve().parent.parent / "data/standins/standin_tex_checker.ply"
    lines = [b"comment TextureFile tex.exr" if b"TextureFile" in ln else ln
             for ln in src.read_bytes().split(b"\n")]
    (tmp_path / "m.ply").write_bytes(b"\n".join(lines))
    (tmp_path / "tex.exr").write_bytes(data)
    ply_data = load_ply(src)
    testing.write_gltf(tmp_path / "m.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=data)
    for mesh_path in (tmp_path / "m.ply", tmp_path / "m.glb"):
        _same(np.asarray(port.load_mesh(mesh_path, scale=0.01).tex), want)
