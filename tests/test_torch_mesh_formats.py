"""The port's mesh readers against the reference's on files each test
writes: a textured PLY with its PNG texture (``load_mesh`` of
``diffdope_tpu/mesh.py:848-967``, the texture read by ``_load_texture``),
binary and ascii STL (``load_stl``) and glTF, a ``.glb`` with its texture
embedded as PNG and a ``.gltf`` with ``data:`` URIs, placed by a node
transform (``load_glb``).  Arrays are held exactly; the baked corner
colours within 1e-6.  A .glb with an embedded JPEG reads as the
reference's, the JPEG decoded as cv2 decodes it.  Computed vertex normals
(those of a file without any) agree within 1e-6: the two packages sum a
vertex's face normals in different orders."""

import shutil
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import mesh as port  # noqa: E402
from diffdope_tpu_torch.testing import png_bytes, write_gltf, write_png, write_stl  # noqa: E402
from torch_scene import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
STANDIN = REPO / "data/standins/standin_asym.ply"
TEXTURED = REPO / "data/standins/standin_tex_checker.ply"
#: a node transform with rotation, non-uniform scale and translation
NODE = {"translation": [0.1, -0.2, 0.3], "rotation": [0.1, 0.2, 0.3, 0.927361849549570],
        "scale": [1.0, 2.0, 0.5]}
MESH_FIELDS = ("pos", "pos_idx", "uv", "uv_idx", "tex", "vtx_color", "edge_adj",
               "bounding_volume")


def _checker(size=64):
    y, x = np.mgrid[0:size, 0:size]
    img = np.stack([((x // 8 + y // 8) % 2) * 200 + 30, x * 3, y * 3], -1)
    return img.astype(np.uint8)


def _same_mesh(got, want, atol_colors=1e-6):
    for key in MESH_FIELDS:
        a, b = getattr(got, key), getattr(want, key)
        if b is None:
            assert a is None, key
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
    # computed normals (a file's own are read exactly): the reference sums
    # each vertex's face normals in its C++ helper's order
    np.testing.assert_allclose(got.vtx_normals, want.vtx_normals, rtol=0, atol=1e-6)
    assert (got.num_vertices, got.num_triangles) == (want.num_vertices, want.num_triangles)
    assert (got.is_closed, got.is_oriented) == (want.is_closed, want.is_oriented)
    if want.corner_colors is None:
        assert got.corner_colors is None
    else:
        np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0,
                                   atol=atol_colors)


def test_torch_textured_ply_reads_its_png(tmp_path):
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh
    from tools.make_standins import make_texture

    ply = tmp_path / TEXTURED.name
    shutil.copy(TEXTURED, ply)
    tex = np.round(make_texture("checker", size=256) * 255).astype(np.uint8)
    write_png(tmp_path / "standin_checker.png", tex, filters="cycle")
    got, want = port.load_mesh(ply, scale=0.01), ref_load_mesh(ply, scale=0.01)
    assert got.has_textured_map and want.has_textured_map
    _same_mesh(got, want)
    np.testing.assert_array_equal(got.tex, tex.astype(np.float32) / 255.0)
    # texture_path= overrides the TextureFile
    other = tmp_path / "other.png"
    write_png(other, _checker())
    _same_mesh(port.load_mesh(ply, texture_path=other),
               ref_load_mesh(ply, texture_path=other))


@pytest.mark.parametrize("binary", [True, False])
def test_torch_stl_matches_reference(tmp_path, binary):
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh
    from diffdope_tpu.mesh import load_stl as ref_load_stl

    data = port.load_ply(STANDIN)
    stl = tmp_path / "m.stl"
    write_stl(stl, data["vertices"], data["faces"], binary=binary)
    got, want = port.load_stl(stl), ref_load_stl(stl)
    assert set(got) == set(want) == {"vertices", "faces"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["vertices"]) == len(data["vertices"])  # welded back
    _same_mesh(port.load_mesh(stl, scale=0.01), ref_load_mesh(stl, scale=0.01))


@pytest.mark.parametrize("suffix", [".glb", ".gltf"])
def test_torch_gltf_matches_reference(tmp_path, suffix):
    from diffdope_tpu.mesh import load_glb as ref_load_glb
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    data = port.load_ply(TEXTURED)
    verts, faces = data["vertices"], data["faces"]
    uv = np.stack([data["uv"][:, 0], 1.0 - data["uv"][:, 1]], -1)  # glTF: v down
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    path = tmp_path / f"m{suffix}"
    write_gltf(path, verts, faces, uv=uv, normals=normals,
               image=png_bytes(_checker(), filters="cycle"), node=NODE)
    got, want = port.load_glb(path), ref_load_glb(path)
    assert set(got) == set(want)
    assert {"vertices", "faces", "normals", "uv", "texture_image"} <= set(want)
    for key in want:
        if key == "uv_origin":
            assert got[key] == want[key] == "top"
            continue
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["texture_image"], _checker().astype(np.float32) / 255.0)
    _same_mesh(port.load_mesh(path, scale=0.01), ref_load_mesh(path, scale=0.01))


def test_torch_gltf_embedded_jpeg_matches_reference(tmp_path):
    """A .glb whose texture is an embedded JPEG: both ``load_glb``s decode
    it (cv2.imdecode in the reference, ``jpeg.py`` in the port) to the same
    float32 texture, and ``load_mesh`` gives the same mesh."""
    from diffdope_tpu.mesh import load_glb as ref_load_glb
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    data = port.load_ply(TEXTURED)
    ok, jpeg = cv2.imencode(".jpg", _checker())
    assert ok
    path = tmp_path / "m.glb"
    uv = np.stack([data["uv"][:, 0], 1.0 - data["uv"][:, 1]], -1)  # glTF: v down
    write_gltf(path, data["vertices"], data["faces"], uv=uv, image=jpeg.tobytes())
    got, want = port.load_glb(path), ref_load_glb(path)
    assert set(got) == set(want)
    assert "texture_image" in want
    for key in want:
        if key == "uv_origin":
            assert got[key] == want[key] == "top"
            continue
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _same_mesh(port.load_mesh(path, scale=0.01), ref_load_mesh(path, scale=0.01))
