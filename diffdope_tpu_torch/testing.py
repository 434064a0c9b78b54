"""Synthetic scenes for tests, the bench and the chip smoke run.

Counterpart of ``diffdope_tpu/testing.py``: the same procedural icosphere
(copied, not imported — importing the JAX package pulls in jax), the
bench protocol's scene as plain numpy arrays, the synthetic refinement
problem (:func:`synthetic_scene`, torch tensors), textured stand-ins from
arrays, and minimal PNG, STL and glTF writers (:func:`write_png`,
:func:`write_stl`, :func:`write_gltf`) for tests and smoke runs that must
write such files where no cv2 is installed.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple, Union

import numpy as np

from diffdope_tpu_torch import geometry as geo
from diffdope_tpu_torch.mesh import Mesh, build_edge_adjacency, mesh_from_arrays


def icosphere(subdiv: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: (N,3) float32 vertices, (T,3) int32 faces.

    20 * 4**subdiv triangles (subdiv=3 -> 1280, 4 -> 5120, 5 -> 20480).
    """
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v[0])
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        cache: dict = {}
        verts = list(map(tuple, v))
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for (a, b, c) in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts, np.float64)
        f = np.asarray(new_faces, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def bench_scene(
    resolution: Tuple[int, int] = (400, 400), subdiv: int = 5
) -> Dict[str, np.ndarray]:
    """The bench protocol's problem (root ``bench.py:70-181``) as numpy.

    An icosphere of the given subdivision (radius 0.4) with positional
    vertex colours, a pinhole camera with f = 1.2 * max(H, W), the gt pose
    (axis (0.2, 1, 0.1), 0.8 rad, 2 units in front of the camera), and the
    initial pose: the gt rotated by 8 degrees about an axis drawn from
    ``np.random.default_rng(0)`` and shifted by (0.02, -0.015, 0.04).
    """
    h, w = resolution
    f = 1.2 * max(h, w)
    proj = geo.projection_from_intrinsics(
        f, f, w / 2, h / 2, w, h, 0.01, 100.0
    ).astype(np.float32)
    v, fc = icosphere(subdiv)
    rng = np.random.default_rng(0)
    q_gt = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8)
    t_gt = np.array([0.0, 0.0, -2.0])
    dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(8.0))
    q0 = geo.quat_multiply_np(dq, q_gt)
    t0 = t_gt + np.array([0.02, -0.015, 0.04])
    return {
        "proj": proj,
        "pos": (v * 0.4).astype(np.float32),
        "tri": fc.astype(np.int32),
        "edge_adj": build_edge_adjacency(fc),
        "vtx_color": (v * 0.5 + 0.5).astype(np.float32),
        "q_gt": q_gt.astype(np.float32),
        "t_gt": t_gt.astype(np.float32),
        "q0": q0.astype(np.float32),
        "t0": t0.astype(np.float32),
    }


def synthetic_scene(
    subdiv: int = 3,
    resolution: Tuple[int, int] = (128, 128),
    batchsize: int = 8,
    seed: int = 0,
    perturb_deg: float = 10.0,
    perturb_trans: float = 0.08,
    radius: float = 0.4,
    distance: float = 3.0,
    raster_impl: str = "auto",
    device="cuda",
) -> Dict:
    """A whole synthetic refinement problem (``testing.py:68-131``) on
    ``device``: an icosphere of radius ``radius`` with positional vertex
    colours, its gt pose (a random axis and angle, ``distance`` in front
    of the camera) and the gt render there, and the B initial poses, the
    gt rotated by ``perturb_deg`` about a random axis and moved by
    ``perturb_trans`` per axis.  The numpy draws are the reference's, in
    its order, so ``q_gt``, ``t_gt`` and ``params0`` are its values.

    ``raster_impl`` is :func:`render_batch`'s: 'reference' the brute
    force, 'pallas' the kernels, 'auto' the brute force for at most 256
    triangles.  Returns a dict with: render_fn (mtx -> renders), gt,
    params0, q_gt, t_gt, proj, pos, tri, vtx_color, edge_adj, resolution.
    """
    import torch

    from diffdope_tpu_torch.optimize import pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import render_batch

    h, w = resolution
    f = 1.2 * max(h, w)
    proj = torch.as_tensor(geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01,
                                                          100.0), dtype=torch.float32)
    verts, faces = icosphere(subdiv)
    pos = torch.as_tensor(verts * radius)
    tri = torch.as_tensor(faces)
    vtx_color = torch.as_tensor((verts * 0.5 + 0.5).astype(np.float32))
    edge_adj = torch.as_tensor(build_edge_adjacency(faces))

    def render_fn(mtx):
        return render_batch(proj, mtx, pos, tri, resolution, vtx_color=vtx_color,
                            raster_impl=raster_impl, edge_adj=edge_adj, device=device)

    rng = np.random.default_rng(seed)
    q_gt = geo.quat_from_axis_angle(rng.normal(size=3), rng.uniform(0, np.pi))
    t_gt = np.array([0.0, 0.0, -distance])
    mtx_gt, _, _ = pose_matrix(pose_params(q_gt, t_gt, 1, device))
    with torch.no_grad():
        gt_render = render_fn(mtx_gt)
    gt = {"rgb": gt_render["rgb"][0], "segmentation": gt_render["mask"][0],
          "depth": gt_render["depth"][0]}

    dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(perturb_deg))
    # the reference multiplies in float32
    q0 = geo.quat_multiply(torch.as_tensor(dq, dtype=torch.float32),
                           torch.as_tensor(q_gt, dtype=torch.float32)).numpy()
    t0 = t_gt + rng.normal(size=3) * perturb_trans
    params0 = pose_params(q0.astype(np.float32), t0.astype(np.float32), batchsize, device)

    return dict(render_fn=render_fn, gt=gt, params0=params0, q_gt=q_gt, t_gt=t_gt,
                proj=proj, pos=pos, tri=tri, vtx_color=vtx_color, edge_adj=edge_adj,
                resolution=resolution)


def spherical_uv(pos: np.ndarray) -> np.ndarray:
    """(N, 2) float32 spherical uv of vertices about the origin (the JAX
    texture tests' formula, ``tests/test_fused_loss.py:271-276``)."""
    n = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-9)
    return np.stack([0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
                     0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi],
                    axis=1).astype(np.float32)


def quantize8(tex: np.ndarray) -> np.ndarray:
    """A [0, 1] texture rounded to 8 bits and back, as a PNG load gives it."""
    return np.round(np.asarray(tex) * 255).astype(np.uint8).astype(np.float32) / 255


def textured_mesh(verts: np.ndarray, faces: np.ndarray, uv: np.ndarray,
                  tex: np.ndarray, scale: float = 1.0) -> Mesh:
    """A textured stand-in mesh from arrays, as ``load_mesh`` builds a
    textured PLY (V flip of the file's uv, winding, padding, baked corner
    colours; ``mesh.mesh_from_arrays``): e.g. ``tools/make_standins.py``'s
    ``make_asym_uv()`` geometry (or ``data/standins/standin_tex_*.ply``)
    with a ``make_texture`` image."""
    return mesh_from_arrays(verts, faces, scale, uv=uv, tex=tex)


#: a sliver of the default configuration's frame (960x540, padded to
#: 960x544; hypothesis 4 at step 12 of its run under DD_RASTER=v3): lanes
#: 0-12 (edge planes, z plane, det) and 28-31 (its vertex bounds in NDC) of
#: its packed row as f32.  Its f32 planes cover pixel SLIVER_PIXEL (row,
#: column), which its vertex bounds put 8 rows away (rows 101-103, column
#: 326): the case a raster that skips by vertex bounds gets wrong.
SLIVER_LANES = {0: 0.003505706787109375, 1: -0.00049591064453125, 2: 0.0008153915405273438,
                3: 0.4310111999511719, 4: -0.058162689208984375, 5: 0.10189437866210938,
                6: -0.4336738586425781, 7: 0.058544158935546875, 8: -0.10251045227050781,
                9: -1.8358230590820312e-05, 10: -2.1457672119140625e-06,
                11: -3.933906555175781e-06, 12: 6.455928087234497e-06,
                28: -0.32055214047431946, 29: -0.31952375173568726, 30: -0.6235520243644714,
                31: -0.6159341335296631}
SLIVER_FRAME = (540, 960)
SLIVER_PIXEL = (111, 328)


def sliver_rows(batch: int = 2, width: int = 32) -> np.ndarray:
    """(batch, width) rows of the sliver (``SLIVER_LANES``, the lanes below
    ``width``; lane 13, the id, 5): even hypotheses in its winding, odd
    ones in the other (the planes and det negated, z unchanged)."""
    rows = np.zeros((batch, width), np.float32)
    for lane, value in SLIVER_LANES.items():
        if lane < width:
            rows[:, lane] = value
    rows[:, 13] = 5.0
    rows[1::2, :9] *= -1.0
    rows[1::2, 12] *= -1.0
    return rows


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Scanlines (h, stride) uint8 filtered with filter type ``kinds[y]``
    each, every line after its filter byte."""
    cur = rows.astype(np.int32)
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    upleft = np.zeros_like(cur)
    upleft[1:, bpp:] = cur[:-1, :-bpp]
    preds = (np.zeros_like(cur), left, up, (left + up) >> 1, _paeth(left, up, upleft))
    out = bytearray()
    for y, k in enumerate(kinds):
        out.append(k)
        out += ((cur[y] - preds[k][y]) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(samples: np.ndarray, color_type: int, bit_depth: int,
               filters: Union[str, int] = "none", interlace: bool = False,
               palette: Optional[np.ndarray] = None, trns: Optional[bytes] = None,
               level: int = 6, idat_size: int = 1 << 16) -> bytes:
    """PNG bytes of ``samples`` (H, W, C) as stored (palette indices for
    colour type 3, values below 8 bits unscaled): each scanline filtered
    with ``filters`` (a type 0-4, "none", or "cycle": row y of each pass
    takes type y % 5, so a decode runs all five), Adam7 with
    ``interlace``, the stream split into IDAT chunks of ``idat_size``."""
    samples = np.asarray(samples)
    h, w, ch = samples.shape
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),))
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        if bit_depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(ph, pw * ch * 2)
        elif bit_depth == 8:
            rows = sub.astype(np.uint8).reshape(ph, pw * ch)
        else:
            vals = sub.reshape(ph, pw * ch).astype(np.uint8)
            bits = (vals[..., None] >> np.arange(bit_depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(ph, -1).astype(np.uint8), axis=1)
        bpp = max(1, ch * bit_depth // 8)
        kinds = ([y % 5 for y in range(ph)] if filters == "cycle"
                 else [0 if filters == "none" else int(filters)] * ph)
        raw += _filter_rows(rows, bpp, kinds)
    stream = zlib.compress(raw, level)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bit_depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for at in range(0, len(stream), idat_size):
        out += _chunk(b"IDAT", stream[at:at + idat_size])
    return out + _chunk(b"IEND", b"")


def write_png(path, array: np.ndarray, filters: Union[str, int] = "none") -> None:
    """Write an 8-bit (uint8) or 16-bit (uint16) grey (H, W), RGB (H, W, 3)
    or RGBA (H, W, 4) image as a PNG (channels in RGB order, as the file
    stores them; ``cv2.imwrite`` takes BGR), rows filtered as
    :func:`encode_png`'s ``filters`` says."""
    with open(path, "wb") as f:
        f.write(png_bytes(array, filters))


def write_stl(path, vertices: np.ndarray, faces: np.ndarray, binary: bool = True) -> None:
    """Write a triangle mesh as an STL file (binary, or ascii ``solid``),
    each facet's normal from its corners."""
    tri = np.asarray(vertices, np.float32)[np.asarray(faces)]  # (T, 3, 3)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20))
    if binary:
        rec = np.zeros(len(tri), np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                           ("attr", "<u2")]))
        rec["n"], rec["v"] = nrm, tri
        with open(path, "wb") as f:
            f.write(b"solid binary stl".ljust(80, b" ")
                    + struct.pack("<I", len(tri)) + rec.tobytes())
        return
    lines = ["solid mesh"]
    for n, t in zip(nrm, tri):
        lines.append("facet normal {:.9g} {:.9g} {:.9g}".format(*n))
        lines.append("  outer loop")
        lines += ["    vertex {:.9g} {:.9g} {:.9g}".format(*v) for v in t]
        lines += ["  endloop", "endfacet"]
    lines.append("endsolid mesh")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_gltf(path, vertices: np.ndarray, faces: np.ndarray, uv=None, normals=None,
               image: Optional[bytes] = None, node: Optional[dict] = None) -> None:
    """Write a one-primitive glTF 2.0 mesh: a ``.glb`` (the buffer and the
    ``image`` bytes, e.g. a PNG, in its BIN chunk) or a ``.gltf`` (the
    buffer and the image as ``data:`` URIs).  ``uv`` is TEXCOORD_0 (v down,
    glTF's convention); ``node`` (e.g. translation / rotation / scale)
    places the mesh."""
    import base64
    import json

    arrays = [("POSITION", np.asarray(vertices, "<f4"), "VEC3", 5126)]
    if normals is not None:
        arrays.append(("NORMAL", np.asarray(normals, "<f4"), "VEC3", 5126))
    if uv is not None:
        arrays.append(("TEXCOORD_0", np.asarray(uv, "<f4"), "VEC2", 5126))
    blob, views, accessors, attrs = b"", [], [], {}
    for name, arr, kind, ctype in arrays + [
            ("indices", np.asarray(faces, "<u4").reshape(-1, 1), "SCALAR", 5125)]:
        data = arr.tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "count": len(arr), "type": kind}
        if name == "POSITION":
            acc.update(min=arr.min(0).tolist(), max=arr.max(0).tolist())
        accessors.append(acc)
        blob += data + b"\0" * (-len(data) % 4)
        if name != "indices":
            attrs[name] = len(accessors) - 1
    prim = {"attributes": attrs, "indices": len(accessors) - 1, "mode": 4}
    gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
            "nodes": [dict(node or {}, mesh=0)], "meshes": [{"primitives": [prim]}],
            "accessors": accessors, "bufferViews": views}
    glb = str(path).lower().endswith(".glb")
    if image is not None:
        prim["material"] = 0
        gltf.update(materials=[{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}}}], textures=[{"source": 0}])
        if glb:
            views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(image)})
            gltf["images"] = [{"bufferView": len(views) - 1, "mimeType": "image/png"}]
            blob += image + b"\0" * (-len(image) % 4)
        else:
            gltf["images"] = [{"uri": "data:image/png;base64,"
                               + base64.b64encode(image).decode()}]
    if not glb:
        gltf["buffers"] = [{"byteLength": len(blob), "uri":
                            "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}]
        with open(path, "w") as f:
            json.dump(gltf, f)
        return
    gltf["buffers"] = [{"byteLength": len(blob)}]
    head = json.dumps(gltf).encode()
    head += b" " * (-len(head) % 4)
    body = (struct.pack("<II", len(head), 0x4E4F534A) + head
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, 12 + len(body)) + body)


def png_bytes(array: np.ndarray, filters: Union[str, int] = "none") -> bytes:
    """:func:`write_png`'s bytes, without a file."""
    array = np.asarray(array)
    if array.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"a PNG holds uint8 or uint16, not {array.dtype}")
    samples = array[..., None] if array.ndim == 2 else array
    return encode_png(samples, {1: 0, 3: 2, 4: 6}[samples.shape[-1]], 8 * array.itemsize,
                      filters)
