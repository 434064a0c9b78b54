"""Synthetic scenes for tests, the bench and the chip smoke run.

Counterpart of ``diffdope_tpu/testing.py``: the same procedural icosphere
(copied, not imported — importing the JAX package pulls in jax), the
bench protocol's scene as plain numpy arrays, the synthetic refinement
problem (:func:`synthetic_scene`, torch tensors), textured stand-ins from
arrays, and minimal PNG, STL and glTF writers (:func:`write_png`,
:func:`write_stl`, :func:`write_gltf`) for tests and smoke runs that must
write such files where no cv2 is installed.  TIFF, BMP, Netpbm, PAM and
PFM writers (:func:`encode_tiff`, :func:`encode_bmp`, :func:`encode_pnm`,
:func:`encode_pam`, :func:`encode_pfm`) write the variants cv2 cannot,
and :func:`image_variants` is the set of small files the readers are
held to cv2 on.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
    # the mesh on ``device`` once: a step then copies no host data
    proj = torch.as_tensor(geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01,
                                                          100.0), dtype=torch.float32,
                           device=device)
    verts, faces = icosphere(subdiv)
    pos = torch.as_tensor(verts * radius, device=device)
    tri = torch.as_tensor(faces, device=device)
    vtx_color = torch.as_tensor((verts * 0.5 + 0.5).astype(np.float32), device=device)
    edge_adj = torch.as_tensor(build_edge_adjacency(faces), device=device)

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


# ---------------------------------------------------------------------------
# TIFF, BMP and Netpbm writers: the variants cv2 cannot write
# ---------------------------------------------------------------------------

def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW of ``data``: a Clear first, codes of 9 to 12 bits packed
    most significant bit first, each width taken one code early (libtiff's
    encoder), a Clear when the table is full, EOI last.  ``old_style``
    writes the pre-6.0 form instead: codes least significant bit first,
    widths taken on time."""
    table = {bytes([i]): i for i in range(256)}
    codes, free, early = [256], 258, 0 if old_style else 1
    codes_w = [9]
    width = 9

    def emit(code):
        codes.append(code)
        codes_w.append(width)

    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = free
        free += 1
        if free + early > (1 << width):
            width += 1
        if free >= 4094:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            free, width = 258, 9
        w = bytes([byte])
    if w:
        emit(table[w])
        free += 1
        if free + early > (1 << width) and width < 12:
            width += 1
    emit(257)
    acc, nacc, out = 0, 0, bytearray()
    for code, nbits in zip(codes, codes_w):
        if old_style:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8
            acc &= (1 << nacc) - 1
    if nacc:
        out.append(acc & 255 if old_style else (acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as (1 - n, byte), the rest as
    literal blocks of at most 128 bytes."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(data)

    def flush():
        for at in range(0, len(lit), 128):
            block = lit[at:at + 128]
            out.append(len(block) - 1)
            out.extend(block)
        lit.clear()

    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            flush()
            out += bytes([(257 - run) & 255, data[i]])
        else:
            lit.extend(data[i:i + run])
        i += run
    flush()
    return bytes(out)


#: TIFF field types: (code, numpy format without byte order)
_TIFF_TYPES = {3: "u2", 4: "u4", 7: "u1", 16: "u8"}


def _tiff_ifd(entries, end: str, at: int, big: bool) -> bytes:
    """An IFD at file offset ``at``: ``entries`` (tag, type, values) in tag
    order, values that do not fit an entry after it."""
    head, slot = (8, 8) if big else (2, 4)
    size = head + len(entries) * (20 if big else 12) + slot
    count_fmt, off_fmt = ("Q", "Q") if big else ("H", "I")
    body, extra = struct.pack(end + count_fmt, len(entries)), b""
    for tag, kind, values in sorted(entries):
        raw = np.asarray(values, end + _TIFF_TYPES[kind]).tobytes()
        body += struct.pack(end + "HH" + ("Q" if big else "I"), tag, kind, len(values))
        if len(raw) <= slot:
            body += raw.ljust(slot, b"\0")
        else:
            body += struct.pack(end + off_fmt, at + size + len(extra))
            extra += raw + b"\0" * (len(raw) % 2)
    return body + b"\0" * slot + extra


def encode_tiff(samples: np.ndarray, photometric: Optional[int] = None,
                compression: int = 1, predictor: int = 1, big_endian: bool = False,
                rows_per_strip: Optional[int] = None, tile: Optional[Tuple[int, int]] = None,
                planar: int = 1, colormap: Optional[np.ndarray] = None,
                extra_samples: Optional[Tuple[int, ...]] = None,
                orientation: Optional[int] = None, sample_format: Optional[int] = None,
                bits: Optional[int] = None, bigtiff: bool = False,
                old_lzw: bool = False, fill_order: int = 1,
                coded: Optional[List[bytes]] = None,
                tags: Sequence[Tuple[int, int, list]] = ()) -> bytes:
    """TIFF bytes of ``samples`` (H, W) or (H, W, C) as stored (palette
    indices for ``photometric`` 3, RGB order): uint8, uint16, float32 or
    any other dtype, or ``bits`` 1, 2 or 4 packed from uint8 values.

    ``compression`` 1 (none), 5 (LZW; ``old_lzw`` the pre-6.0 bit order),
    8 or 32946 (deflate) or 32773 (PackBits) compresses each strip or tile;
    any other value is written into the tag over uncompressed data.
    ``predictor`` 2 differences each row's samples, 3 shuffles each row's
    bytes into planes (most significant first) and differences them.
    Strips of ``rows_per_strip`` rows (all rows by default) or ``tile``
    (width, height) tiles, ``planar`` 2 for one plane a sample, a
    ``colormap`` (3, 2**bits) uint16, ``extra_samples`` (338), an
    ``orientation`` (274) and a ``sample_format`` (339) tag.  ``bigtiff``
    writes the 64-bit form (BigTIFF); ``fill_order`` 2 stores each byte
    with its bits reversed (FillOrder 266), the compressed bytes too.
    ``coded`` gives each strip's or
    tile's bytes as they are to be stored (a JPEG stream a strip for
    ``compression`` 7), in place of ``samples``' own; ``tags`` adds
    entries (tag, TIFF type, values), such as JPEGTables (347, 7) or
    YCbCrSubsampling (530, 3)."""
    arr = np.asarray(samples)
    arr3 = arr[..., None] if arr.ndim == 2 else arr
    h, w, spp = arr3.shape
    bps = bits or 8 * arr.itemsize
    end = ">" if big_endian else "<"
    if photometric is None:
        photometric = 1 if spp < 3 else 2
    if sample_format is None:
        sample_format = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    planes = [arr3[..., c:c + 1] for c in range(spp)] if planar == 2 else [arr3]
    bw, bh = tile if tile else (w, rows_per_strip or h)
    stride = 0
    # libtiff runs a predictor with LZW and deflate only
    predictor_on = predictor if compression in (5, 8, 32946) else 1
    nx, ny = (-(-w // bw), -(-h // bh)) if tile else (1, -(-h // bh))

    def block_bytes(block: np.ndarray) -> bytes:
        nonlocal stride
        rows, cols, ch = block.shape
        stride = -(-cols * ch * bps // 8)
        if bps % 8:
            vals = block.reshape(rows, cols * ch).astype(np.uint16)
            bit = (vals[..., None] >> np.arange(bps - 1, -1, -1)) & 1
            return np.packbits(bit.reshape(rows, -1).astype(np.uint8), axis=1).tobytes()
        if predictor_on == 3:
            wc = cols * ch
            be = block.reshape(rows, wc).astype(">" + block.dtype.str[1:])
            planes_ = be.view(np.uint8).reshape(rows, wc, -1).transpose(0, 2, 1)
            flat = planes_.reshape(rows, -1).astype(np.int32)
            flat[:, ch:] = flat[:, ch:] - flat[:, :-ch]
            return (flat & 255).astype(np.uint8).tobytes()
        if predictor_on == 2:
            kind = block.dtype.str[1:].replace("i", "u").replace("f", "u")
            u = np.ascontiguousarray(block).view(kind).reshape(rows, cols, ch)
            d = u.copy()
            d[:, 1:] = u[:, 1:] - u[:, :-1]  # wraps, as the unsigned samples do
            block = d.view(block.dtype).reshape(rows, cols, ch)
        return block.astype(end + block.dtype.str[1:]).tobytes()

    def compress(raw: bytes) -> bytes:
        if compression == 5:
            return lzw_encode(raw, old_lzw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:  # each row on its own, as libtiff packs them
            return b"".join(packbits_encode(raw[r * stride:(r + 1) * stride])
                            for r in range(len(raw) // stride))
        return raw

    blocks = []
    for plane in planes:
        for by in range(ny):
            for bx in range(nx):
                block = plane[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw]
                if tile:  # tiles are whole: the edge ones padded
                    pad = np.zeros((bh, bw, block.shape[2]), block.dtype)
                    pad[:block.shape[0], :block.shape[1]] = block
                    block = pad
                stored = compress(block_bytes(block)) if coded is None else coded[len(blocks)]
                if fill_order == 2:
                    bits_ = np.unpackbits(np.frombuffer(stored, np.uint8)[:, None], axis=1)
                    stored = np.packbits(bits_[:, ::-1], axis=1).tobytes()
                blocks.append(stored)
    head = 16 if bigtiff else 8
    offsets, data = [], b""
    for block in blocks:
        offsets.append(head + len(data))
        data += block + b"\0" * (len(block) % 2)
    ifd_at = head + len(data)
    off_type = 16 if bigtiff else 4
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [planar]),
               (339, 3, [sample_format] * spp)]
    if tile:
        entries += [(322, 4, [bw]), (323, 4, [bh]), (324, off_type, offsets),
                    (325, 4, [len(b) for b in blocks])]
    else:
        entries += [(273, off_type, offsets), (278, 4, [bh]),
                    (279, 4, [len(b) for b in blocks])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, np.asarray(colormap, np.uint16).reshape(-1).tolist()))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    entries += list(tags)
    if bigtiff:
        magic = (b"MM\x00+" if big_endian else b"II+\x00") + struct.pack(end + "HHQ", 8, 0,
                                                                          ifd_at)
    else:
        magic = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(end + "I", ifd_at)
    return magic + data + _tiff_ifd(entries, end, ifd_at, bigtiff)


def jpeg_split_tables(stream: bytes) -> Tuple[bytes, bytes]:
    """A JPEG stream as JPEG-in-TIFF stores it with shared tables: (the
    tables-only stream SOI DQT.. DHT.. EOI, the abbreviated stream without
    its tables and APPn segments)."""
    at, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while at + 4 <= len(stream):
        marker = stream[at + 1]
        (length,) = struct.unpack(">H", stream[at + 2:at + 4])
        seg = stream[at:at + 2 + length]
        if marker == 0xDA:
            return tables + b"\xff\xd9", rest + stream[at:]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        at += 2 + length
    raise ValueError("a JPEG stream without a scan")


def encode_jpeg_tiff(samples: np.ndarray, encode, rows_per_strip: Optional[int] = None,
                     tile: Optional[Tuple[int, int]] = None, photometric: int = 6,
                     subsampling: Optional[Tuple[int, int]] = (2, 2), shared_tables: bool = True,
                     **kwargs) -> bytes:
    """JPEG-in-TIFF (compression 7) bytes of ``samples`` (H, W) grey or (H,
    W, 3) RGB: ``encode`` (an array, RGB or grey, -> a JPEG stream, such as
    cv2's ``imencode`` in the caller) codes each strip of
    ``rows_per_strip`` rows (the last one shorter) or each ``tile`` (width,
    height; the edge ones padded with zeros); ``shared_tables`` moves the
    quantisation and Huffman tables into JPEGTables (347) and stores
    abbreviated streams.  ``photometric`` 6 (YCbCr) writes
    ``subsampling`` as YCbCrSubsampling (530); 2 (RGB) and 1 (grey) store
    the components as coded.  Other keywords go to :func:`encode_tiff`."""
    arr = np.asarray(samples)
    h, w = arr.shape[:2]
    coded = []
    if tile:
        tw, th = tile
        for by in range(0, h, th):
            for bx in range(0, w, tw):
                block = np.zeros((th, tw) + arr.shape[2:], arr.dtype)
                part = arr[by:by + th, bx:bx + tw]
                block[:part.shape[0], :part.shape[1]] = part
                coded.append(encode(block))
    else:
        rows = rows_per_strip or h
        coded = [encode(arr[y:y + rows]) for y in range(0, h, rows)]
    tags = list(kwargs.pop("tags", ()))
    if shared_tables:
        split = [jpeg_split_tables(c) for c in coded]
        coded = [rest for _, rest in split]
        tags.append((347, 7, list(split[0][0])))
    if photometric == 6 and subsampling is not None:
        tags.append((530, 3, list(subsampling)))
    return encode_tiff(arr, photometric=photometric, compression=7,
                       rows_per_strip=rows_per_strip, tile=tile, coded=coded, tags=tags,
                       **kwargs)


def _rle_row(row: np.ndarray, four: bool, eol_tail: bool, delta: bool) -> Tuple[bytes, int]:
    """One row of RLE8 (``four`` False) or RLE4 palette indices: runs of
    equal indices (RLE4: of alternating nibble pairs) as (count, value),
    other stretches of 3 or more as absolute blocks padded to 16 bits.
    ``eol_tail`` drops the row's trailing zero indices (the end of line
    ends it early), ``delta`` writes each run of 4 or more zeros as a
    delta escape (0, 2, dx, 0).  Returns the bytes and the number of
    pixels the row leaves to the decoder's fill."""
    vals = row.tolist()
    n = len(vals)
    if eol_tail:
        while n and vals[n - 1] == 0:
            n -= 1
    out, i, lit = bytearray(), 0, []
    cap = 255 if not four else 254

    def flush():
        at = 0
        while at < len(lit):
            block = lit[at:at + cap]
            at += len(block)
            if len(block) < 3:
                for v in block:
                    out.extend((1, (v << 4) | v if four else v))
                continue
            out.extend((0, len(block)))
            if four:
                pad = block + [0] * (len(block) % 2)
                data = bytes((pad[k] << 4) | pad[k + 1] for k in range(0, len(pad), 2))
            else:
                data = bytes(block)
            out.extend(data + b"\0" * (len(data) % 2))
        lit.clear()

    while i < n:
        run = 1
        while i + run < n and run < cap and vals[i + run] == vals[i]:
            run += 1
        if delta and vals[i] == 0 and run >= 4 and i + run < n:
            flush()
            out.extend((0, 2, run, 0))
        elif run >= 3:
            flush()
            v = vals[i]
            out.extend((run, (v << 4) | v if four else v))
        else:
            lit.extend(vals[i:i + run])
        i += run
    flush()
    return bytes(out), len(vals) - n


def encode_bmp(pixels: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
               header: int = 40, rle: bool = False, top_down: bool = False,
               masks: Optional[Tuple[int, int, int, int]] = None,
               colors_used: Optional[int] = None, eol_tail: bool = False,
               delta: bool = False, early_end: bool = False) -> bytes:
    """BMP bytes.  ``pixels`` is (H, W) palette indices for ``bits`` 1, 4
    or 8 (``palette`` (n, 3) RGB, written BGR0, or BGR with the 12-byte
    header), (H, W) uint16 words for 16, (H, W, 3) RGB for 24 and (H, W,
    4) RGBA for 32.  ``header`` is the info header's size (12, 40, 108 or
    124); ``masks`` (red, green, blue, alpha) writes BI_BITFIELDS (in the
    header from 108 bytes on, after a 40-byte one otherwise); ``rle``
    writes RLE8 at 8 bits, RLE4 at 4 (with ``eol_tail``, ``delta`` as
    :func:`_rle_row`; ``early_end`` ends the bitmap before its trailing
    rows of zero indices).  Rows are bottom-up unless ``top_down`` (a
    negative height), each padded to 4 bytes; ``colors_used`` is the
    header's palette count (0 for 2**bits entries)."""
    pix = np.asarray(pixels)
    h, w = pix.shape[:2]
    if bits <= 8:
        pal = np.asarray(palette, np.uint8)[:, ::-1]
        if colors_used is None and header != 12:
            colors_used = len(pal) if len(pal) != 1 << bits else 0
        n_pal = 1 << bits if header == 12 else (colors_used or 1 << bits)
        pal = np.concatenate([pal, np.zeros((max(0, n_pal - len(pal)), 3), np.uint8)])[:n_pal]
        if header != 12:
            pal = np.concatenate([pal, np.zeros((n_pal, 1), np.uint8)], axis=1)
        pal_bytes = pal.tobytes()
    else:
        n_pal, pal_bytes = 0, b""
    rows = pix[::-1] if not top_down else pix
    if rle:
        body = bytearray()
        tail_zero = 0
        if early_end:
            while tail_zero < h and not rows[h - 1 - tail_zero].any():
                tail_zero += 1
        for y in range(h - tail_zero):
            data, _ = _rle_row(rows[y], bits == 4, eol_tail, delta)
            body += data + (b"\x00\x00" if y < h - tail_zero - 1 else b"")
        body += b"\x00\x01"
        body = bytes(body)
        comp = 2 if bits == 4 else 1
    else:
        if bits < 8:
            vals = rows.astype(np.uint8)
            bit = (vals[..., None] >> np.arange(bits - 1, -1, -1)) & 1
            packed = np.packbits(bit.reshape(h, -1).astype(np.uint8), axis=1)
        elif bits == 8:
            packed = rows.astype(np.uint8)
        elif bits == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            order = [2, 1, 0] if bits == 24 else [2, 1, 0, 3]
            packed = np.ascontiguousarray(rows[..., order]).astype(np.uint8).reshape(h, -1)
        stride = -(-w * bits // 32) * 4
        buf = np.zeros((h, stride), np.uint8)
        buf[:, :packed.shape[1]] = packed
        body = buf.tobytes()
        comp = 3 if masks is not None else 0
    height = -h if top_down else h
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, height, 1, bits, comp, len(body),
                           2835, 2835, colors_used or 0, 0)
        fields = struct.pack("<4I", *masks) if masks is not None else b"\0" * 16
        if header >= 108:
            info += fields + b"BGRs" + b"\0" * (header - 40 - 20)
            extra = b""
        else:
            extra = fields[:12] if masks is not None else b""
    offset = 14 + len(info) + len(extra) + len(pal_bytes)
    size = offset + len(body)
    return (b"BM" + struct.pack("<IHHI", size, 0, 0, offset) + info + extra + pal_bytes
            + body)


def encode_pnm(samples: np.ndarray, magic: str, maxval: Optional[int] = None,
               comment: Optional[str] = None, line: int = 17) -> bytes:
    """Netpbm bytes: ``magic`` P1-P6 of (H, W) grey or (H, W, 3) RGB
    samples (P1/P4: 1 is black), ``maxval`` (default 255, or 65535 for
    uint16 samples; 2 bytes a sample big-endian above 255), a ``comment``
    line after the magic, ascii samples ``line`` to a line."""
    arr = np.asarray(samples)
    h, w = arr.shape[:2]
    kind = int(magic[1])
    if maxval is None:
        maxval = 65535 if arr.dtype == np.uint16 else 255
    head = magic + "\n" + (f"# {comment}\n" if comment is not None else "") + f"{w} {h}\n"
    if kind not in (1, 4):
        head += f"{maxval}\n"
    flat = arr.reshape(h, -1)
    if kind == 4:
        return head.encode() + np.packbits(flat.astype(np.uint8), axis=1).tobytes()
    if kind >= 4:
        dtype = ">u2" if maxval > 255 else np.uint8
        return head.encode() + flat.astype(dtype).tobytes()
    vals = [str(v) for v in flat.reshape(-1).tolist()]
    sep = "" if kind == 1 else " "
    body = "\n".join(sep.join(vals[at:at + line]) for at in range(0, len(vals), line))
    return (head + body + "\n").encode()


def encode_pam(samples: np.ndarray, maxval: Optional[int] = None,
               tupltype: Optional[str] = None) -> bytes:
    """PAM (P7) bytes of (H, W) or (H, W, C) samples, 2 bytes big-endian
    a sample above a ``maxval`` of 255."""
    arr = np.asarray(samples)
    arr3 = arr[..., None] if arr.ndim == 2 else arr
    h, w, depth = arr3.shape
    if maxval is None:
        maxval = 65535 if arr.dtype == np.uint16 else 255
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
    if tupltype:
        head += f"TUPLTYPE {tupltype}\n"
    dtype = ">u2" if maxval > 255 else np.uint8
    return (head + "ENDHDR\n").encode() + arr3.astype(dtype).tobytes()


def encode_pfm(samples: np.ndarray, scale: float = -1.0) -> bytes:
    """PFM bytes of float32 (H, W) ("Pf") or (H, W, 3) RGB ("PF") samples,
    rows bottom-up, little-endian for a negative ``scale``."""
    arr = np.asarray(samples, np.float32)
    h, w = arr.shape[:2]
    magic = "PF" if arr.ndim == 3 else "Pf"
    dtype = "<f4" if scale < 0 else ">f4"
    return f"{magic}\n{w} {h}\n{scale}\n".encode() + arr[::-1].astype(dtype).tobytes()


def variant_image(h: int, w: int, channels: int, dtype, seed: int) -> np.ndarray:
    """Gradients with noise over a dtype's range (float32: [-2, 3])."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 5.0) * np.cos(y / 4.0) * 0.4 + 0.5)[..., None] \
        * np.linspace(0.4, 1.0, max(channels, 1))
    base = np.clip(base + rng.uniform(-0.1, 0.1, base.shape), 0.0, 1.0)
    if np.dtype(dtype).kind == "f":
        out = (base * 5.0 - 2.0).astype(dtype)
    else:
        out = np.round(base * np.iinfo(dtype).max).astype(dtype)
    return out[..., 0] if channels == 0 else out


#: the modes a variant is read in: both, or only IMREAD_UNCHANGED / COLOR
BOTH, UNCHANGED, COLOR = ("unchanged", "color"), ("unchanged",), ("color",)


#: the committed WebP corpus (``tools/port_webp_corpus.py`` writes it)
WEBP_CORPUS = Path(__file__).resolve().parent.parent / "tests" / "torch_data" / "webp"


def webp_variants() -> Dict[str, Tuple[bytes, Tuple[str, ...]]]:
    """The WebP corpus as ``image_variants`` lists its files: "webp_" and
    the file's stem -> (bytes, both modes).  Lossy and lossless files,
    alpha (VP8L-coded, raw, each filter), animations, EXIF orientations,
    ICC and XMP chunks, truncated and malformed files."""
    return {f"webp_{p.stem}": (p.read_bytes(), BOTH)
            for p in sorted(WEBP_CORPUS.glob("*.webp"))}


def image_variants() -> Dict[str, Tuple[bytes, Tuple[str, ...]]]:
    """Small TIFF, BMP, Netpbm, PAM and PFM files of every variant the
    port's readers decode, each with the cv2 modes it is held to cv2 in:
    name -> (bytes, modes).  Sizes are odd and tiles partial, except
    16-bit tiles (cv2's 8-bit path leaves partial 16-bit tiles
    unwritten) and uncompressed tiles, which are read unchanged at 16 bits
    only (cv2's 8-bit path refuses uncompressed tiles smaller than four
    bytes a pixel)."""
    out: Dict[str, Tuple[bytes, Tuple[str, ...]]] = {}
    h, w = 19, 27
    g8, c8 = variant_image(h, w, 0, np.uint8, 1), variant_image(h, w, 3, np.uint8, 2)
    a8 = variant_image(h, w, 4, np.uint8, 3)
    g16, c16 = variant_image(h, w, 0, np.uint16, 4), variant_image(h, w, 3, np.uint16, 5)
    a16 = variant_image(h, w, 4, np.uint16, 6)
    f32, f3 = variant_image(h, w, 0, np.float32, 7), variant_image(h, w, 3, np.float32, 8)
    # ---- TIFF
    for comp in (1, 5, 8, 32946, 32773):
        for name, arr in (("g8", g8), ("c8", c8), ("a8", a8), ("g16", g16), ("c16", c16),
                          ("a16", a16), ("f32", f32), ("f3", f3)):
            preds = (1, 2, 3) if arr.dtype == np.float32 else (1, 2)
            for pred in preds if comp in (5, 8, 32946) else (1,):
                for be in (False, True):
                    out[f"tiff_{name}_c{comp}_p{pred}_{'be' if be else 'le'}"] = (encode_tiff(
                        arr, compression=comp, predictor=pred, big_endian=be,
                        rows_per_strip=5), BOTH)
    for comp in (5, 8, 32773):
        for name, arr in (("g8", g8), ("c8", c8), ("a8", a8)):
            out[f"tiff_tiles_{name}_c{comp}"] = (encode_tiff(
                arr, compression=comp, predictor=2 if comp != 32773 else 1,
                tile=(16, 16)), BOTH)
    g16t = variant_image(32, 48, 0, np.uint16, 9)
    c16t = variant_image(32, 48, 3, np.uint16, 10)
    f32t = variant_image(h, w, 0, np.float32, 11)
    for comp in (1, 5, 8):
        out[f"tiff_tiles_g16_c{comp}"] = (encode_tiff(g16t, compression=comp, tile=(16, 16),
                                                      big_endian=comp == 8),
                                          BOTH if comp != 1 else UNCHANGED)
        out[f"tiff_tiles_c16_c{comp}"] = (encode_tiff(c16t, compression=comp, tile=(16, 32)),
                                          BOTH if comp != 1 else UNCHANGED)
        out[f"tiff_tiles_f32_c{comp}"] = (encode_tiff(f32t, compression=comp, tile=(16, 16),
                                                      predictor=3 if comp != 1 else 1), BOTH)
    out["tiff_tiles_a8_c1"] = (encode_tiff(a8, tile=(16, 16)), BOTH)
    for name, arr in (("c8", c8), ("a8", a8)):
        for comp in (1, 5, 32773):
            out[f"tiff_planar2_{name}_c{comp}"] = (encode_tiff(
                arr, compression=comp, planar=2, rows_per_strip=4,
                predictor=2 if comp == 5 else 1), BOTH)
    out["tiff_planar2_tiles_c8_c8"] = (encode_tiff(c8, compression=8, planar=2,
                                                   tile=(16, 16)), BOTH)
    out["tiff_planar2_c16_c5"] = (encode_tiff(c16, compression=5, planar=2,
                                              rows_per_strip=4), COLOR)
    out["tiff_planar2_g16_c5"] = (encode_tiff(g16, compression=5, planar=2), BOTH)
    for name, arr in (("g8", g8), ("g16", g16), ("f32", f32)):
        out[f"tiff_whiteiszero_{name}"] = (encode_tiff(arr, photometric=0, compression=5), BOTH)
    idx = variant_image(h, w, 0, np.uint8, 12)
    cmap16 = np.random.default_rng(13).integers(0, 65536, (3, 256)).astype(np.uint16)
    out["tiff_palette_cmap16"] = (encode_tiff(idx, photometric=3, colormap=cmap16,
                                              compression=5), BOTH)
    out["tiff_palette_cmap8"] = (encode_tiff(idx, photometric=3, colormap=cmap16 >> 8,
                                             compression=8, big_endian=True), BOTH)
    for extra in (None, (0,), (1,), (2,)):
        tag = "none" if extra is None else extra[0]
        out[f"tiff_rgba8_extra{tag}"] = (encode_tiff(a8, extra_samples=extra, compression=5),
                                         BOTH)
        out[f"tiff_rgba16_extra{tag}"] = (encode_tiff(a16, extra_samples=extra,
                                                      compression=5), BOTH)
    ga8, ga16 = variant_image(h, w, 2, np.uint8, 14), variant_image(h, w, 2, np.uint16, 15)
    for extra in (None, (2,)):
        tag = "none" if extra is None else extra[0]
        out[f"tiff_grey_alpha8_extra{tag}"] = (encode_tiff(ga8, extra_samples=extra,
                                                           compression=5), BOTH)
        out[f"tiff_grey_alpha16_extra{tag}"] = (encode_tiff(ga16, extra_samples=extra,
                                                            compression=5), BOTH)
    out["tiff_whiteiszero_grey_alpha8"] = (encode_tiff(ga8, photometric=0, compression=5),
                                           BOTH)
    c8t = variant_image(37, 45, 3, np.uint8, 16)
    for o in range(1, 9):
        out[f"tiff_orient{o}_c8"] = (encode_tiff(c8, orientation=o, compression=5,
                                                 rows_per_strip=4), BOTH)
        out[f"tiff_orient{o}_g16"] = (encode_tiff(g16, orientation=o, compression=8,
                                                  rows_per_strip=7), BOTH)
        out[f"tiff_orient{o}_f32"] = (encode_tiff(f32, orientation=o), BOTH)
        out[f"tiff_orient{o}_tiles_c8"] = (encode_tiff(c8t, orientation=o, compression=5,
                                                       tile=(16, 16)), BOTH)
        out[f"tiff_orient{o}_tiles_g16"] = (encode_tiff(g16t, orientation=o, compression=5,
                                                        tile=(16, 16)), UNCHANGED)
    out["tiff_one_column"] = (encode_tiff(g16[:, :1], compression=5, predictor=2), BOTH)
    out["tiff_one_row"] = (encode_tiff(c8[:1], compression=5, predictor=2), BOTH)
    # ---- Netpbm, PAM, PFM
    for magic in ("P2", "P5"):
        for maxval in (1, 100, 255, 1000, 65535):
            top = maxval + 1
            arr = (g16.astype(np.int64) * top // 65536).astype(
                np.uint16 if maxval > 255 else np.uint8)
            out[f"pnm_{magic}_max{maxval}"] = (encode_pnm(arr, magic, maxval), BOTH)
    for magic in ("P3", "P6"):
        for maxval in (100, 255, 1000, 65535):
            arr = (c16.astype(np.int64) * (maxval + 1) // 65536).astype(
                np.uint16 if maxval > 255 else np.uint8)
            out[f"pnm_{magic}_max{maxval}"] = (encode_pnm(arr, magic, maxval), BOTH)
    bits = (g8 > 127).astype(np.uint8)
    out["pnm_P1"] = (encode_pnm(bits, "P1"), BOTH)
    out["pnm_P4"] = (encode_pnm(bits, "P4"), BOTH)
    out["pnm_P5_comment"] = (encode_pnm(g8, "P5", comment="made by a test"), BOTH)
    out["pnm_P2_over_maxval"] = (encode_pnm(g8, "P2", maxval=200), BOTH)
    out["pnm_P5_over_maxval"] = (encode_pnm(g8, "P5", maxval=200), BOTH)
    out["pnm_P6_crlf"] = (b"P6 27 19 255\r\n" + c8.tobytes(), BOTH)
    out["pnm_P2_tabs_comments"] = (b"P2\t# a\n27\n# b\r19 # c\n255\n"
                                   + " ".join(map(str, g8.reshape(-1).tolist())).encode() + b"\n",
                                   BOTH)
    for tupl, arr, modes in (("GRAYSCALE", g8, BOTH), ("RGB", c8, BOTH), ("RGB", c16, BOTH),
                             ("RGB_ALPHA", a8, UNCHANGED), ("GRAYSCALE_ALPHA", ga16, UNCHANGED),
                             (None, c8, BOTH), (None, g8, BOTH)):
        name = f"pam_{tupl or 'none'}_{arr.dtype.name}_{arr.shape[-1] if arr.ndim == 3 else 1}"
        out[name] = (encode_pam(arr, tupltype=tupl), modes)
    out["pam_GRAYSCALE_max1000"] = (encode_pam((g16 % 1001).astype(np.uint16), 1000,
                                               "GRAYSCALE"), BOTH)
    out["pam_RGB_max100"] = (encode_pam((c8 % 101).astype(np.uint8), 100, "RGB"), BOTH)
    for scale in (-1.0, 1.0, -3.0, 2.0):
        out[f"pfm_Pf_{scale}"] = (encode_pfm(f32, scale), UNCHANGED)
        out[f"pfm_PF_{scale}"] = (encode_pfm(f3, scale), BOTH)
    wide = f3 * 80.0 + 100.0
    wide[0, :8, 0] = [np.nan, np.inf, -np.inf, 3e9, 2.5, 3.5, 254.5, 255.5]
    out["pfm_PF_saturating"] = (encode_pfm(wide, -1.0), BOTH)
    # ---- BMP
    grey_pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    col_pal = np.random.default_rng(17).integers(0, 256, (256, 3)).astype(np.uint8)
    for header in (12, 40, 108, 124):
        for pname, pal in (("grey", grey_pal), ("colour", col_pal)):
            for depth in (1, 4, 8):
                n = 1 << depth
                sub = pal[:: 256 // n] if pname == "grey" else pal[:n]
                ix = (idx.astype(np.int64) * n // 256).astype(np.uint8)
                out[f"bmp_h{header}_{pname}_{depth}bit"] = (encode_bmp(ix, depth, sub, header),
                                                            BOTH)
            if header != 12:
                out[f"bmp_h{header}_{pname}_8bit_topdown"] = (encode_bmp(
                    idx, 8, pal, header, top_down=True), BOTH)
    out["bmp_grey16_of_256"] = (encode_bmp(idx % 16, 8, grey_pal[::17][:16],
                                           colors_used=16), BOTH)
    out["bmp_index_past_colors_used"] = (encode_bmp(idx, 8, col_pal[:40], colors_used=40),
                                         BOTH)
    rle_ix = (idx.astype(np.int64) % 3).astype(np.uint8)
    rle_ix[:, 8:15] = 5
    rle_ix[3:5] = 0
    rle_ix[:, 22:] = 0
    rle_ix[-2:] = 0
    for depth in (4, 8):
        for opts in ({}, {"eol_tail": True}, {"delta": True}, {"early_end": True},
                     {"eol_tail": True, "delta": True, "early_end": True}):
            tag = "_".join(sorted(opts)) or "plain"
            for pname, pal in (("grey", grey_pal[::17][:16]), ("colour", col_pal[:16])):
                out[f"bmp_rle{depth}_{tag}_{pname}"] = (encode_bmp(
                    rle_ix, depth, pal, rle=True, **opts), BOTH)
    words = variant_image(h, w, 0, np.uint16, 18)
    out["bmp_16_rgb555"] = (encode_bmp(words & 0x7FFF, 16), BOTH)
    out["bmp_16_bitfields555"] = (encode_bmp(words & 0x7FFF, 16,
                                             masks=(0x7C00, 0x3E0, 0x1F, 0)), BOTH)
    out["bmp_16_bitfields565"] = (encode_bmp(words, 16, masks=(0xF800, 0x7E0, 0x1F, 0)),
                                  BOTH)
    out["bmp_16_bitfields565_topdown"] = (encode_bmp(words, 16, top_down=True,
                                                     masks=(0xF800, 0x7E0, 0x1F, 0)), BOTH)
    out["bmp_24"] = (encode_bmp(c8, 24), BOTH)
    out["bmp_24_topdown"] = (encode_bmp(c8, 24, top_down=True), BOTH)
    out["bmp_24_h12"] = (encode_bmp(c8, 24, header=12), BOTH)
    out["bmp_32_rgb"] = (encode_bmp(a8, 32), BOTH)
    out["bmp_32_h12"] = (encode_bmp(a8, 32, header=12), BOTH)
    for header in (40, 108, 124):
        for mname, masks in (("alpha", (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
                             ("noalpha", (0xFF0000, 0xFF00, 0xFF, 0)),
                             ("swapped", (0xFF, 0xFF00, 0xFF0000, 0xFF000000))):
            out[f"bmp_32_h{header}_{mname}"] = (encode_bmp(a8, 32, header=header,
                                                           masks=masks), BOTH)
    return out


# ---------------------------------------------------------------------------
# GIF, Sun Raster and Radiance HDR writers
# ---------------------------------------------------------------------------

def gif_lzw_encode(indices: bytes, min_size: int, clear_every: Optional[int] = None) -> bytes:
    """GIF LZW of palette ``indices``: a Clear first, codes from
    ``min_size`` + 1 bits wide up to 12, least significant bit first, each
    width taken when the next free code reaches it, a Clear when the table
    is full (or after every ``clear_every`` codes), End last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes: List[Tuple[int, int]] = []
    width = min_size + 1

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_size + 1

    table, free, width = reset()
    codes.append((clear, width))
    w = b""
    emitted = 0
    for byte in indices:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        emitted += 1
        if free < 4096:
            table[wc] = free
            free += 1
            if free > (1 << width) and width < 12:
                width += 1
        if free >= 4096 or (clear_every and emitted % clear_every == 0):
            codes.append((clear, width))
            table, free, width = reset()
        w = bytes([byte])
    if w:
        codes.append((table[w], width))
        if free < 4096:
            free += 1
            if free > (1 << width) and width < 12:
                width += 1
    codes.append((end, width))
    acc, nacc, out = 0, 0, bytearray()
    for code, nbits in codes:
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _gif_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[at:at + 255])]) + data[at:at + 255]
                    for at in range(0, len(data), 255)) + b"\0"


def encode_gif(frames, palette: Optional[np.ndarray] = None,
               screen: Optional[Tuple[int, int]] = None, background: int = 0,
               version: bytes = b"89a", min_size: Optional[int] = None,
               clear_every: Optional[int] = None) -> bytes:
    """GIF bytes.  ``frames`` is a list of (H, W) uint8 palette-index arrays
    or of dicts with ``indices`` and optional ``left``/``top`` (the frame's
    offset on the logical screen), ``palette`` (a local colour table),
    ``interlace``, ``transparent`` (the graphic control extension's
    index), ``disposal`` and ``delay``.  ``palette`` is the global colour
    table ((n, 3) uint8 RGB, n a power of two from 2 to 256; None writes
    none), ``screen`` the logical screen (width, height), by default the
    first frame's size, ``background`` its background index;
    ``min_size`` the LZW minimum code size (by default the colour table's
    bits, at least 2)."""
    frames = [f if isinstance(f, dict) else {"indices": f} for f in frames]
    first = np.asarray(frames[0]["indices"])
    sw, sh = screen or (first.shape[1], first.shape[0])

    def table_bits(pal):
        n = len(pal)
        bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
        return bits, np.concatenate([np.asarray(pal, np.uint8),
                                     np.zeros(((1 << bits) - n, 3), np.uint8)])

    out = bytearray(b"GIF" + version)
    flags = 0
    gct = b""
    if palette is not None:
        bits, pal = table_bits(palette)
        flags = 0x80 | ((bits - 1) << 4) | (bits - 1)
        gct = pal.tobytes()
    out += struct.pack("<HHBBB", sw, sh, flags, background, 0) + gct
    if len(frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f or "delay" in f:
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, f.get("delay", 0),
                                                 t or 0) + b"\0"
        lflags, lct = 0, b""
        local = f.get("palette")
        if local is not None:
            bits, pal = table_bits(local)
            lflags = 0x80 | (bits - 1)
            lct = pal.tobytes()
        else:
            bits = table_bits(palette)[0] if palette is not None else 8
        rows = idx
        if f.get("interlace"):
            lflags |= 0x40
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                    np.arange(1, h, 2)])
            rows = idx[order]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h,
                                     lflags) + lct
        size = min_size or max(2, bits)
        out += bytes([size]) + _gif_blocks(gif_lzw_encode(rows.tobytes(), size, clear_every))
    return bytes(out + b"\x3b")


def sunras_rle(data: bytes) -> bytes:
    """Sun Raster's byte encoding: runs of 3 to 256 equal bytes (and any
    run of 0x80) as 0x80, count - 1, byte; a single 0x80 as 0x80 0x00;
    other bytes as they are."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 256 and data[i + run] == data[i]:
            run += 1
        if run >= 3 or (data[i] == 0x80 and run > 1):
            out += bytes((0x80, run - 1, data[i]))
        elif data[i] == 0x80:
            out += b"\x80\x00"
        else:
            out += data[i:i + run]
        i += run
    return bytes(out)


def encode_sunras(pixels: np.ndarray, depth: int, kind: int = 1,
                  colormap: Optional[np.ndarray] = None, map_length: Optional[int] = None,
                  length: Optional[int] = None) -> bytes:
    """Sun Raster bytes.  ``pixels`` is (H, W) indices (``depth`` 1 to 8,
    most significant bit first) or (H, W, 3) RGB (24 and 32: stored BGR and XBGR, or RGB and
    XRGB for ``kind`` 3).  ``kind`` is the header's type: 0 old, 1
    standard, 2 byte-encoded (:func:`sunras_rle` over all rows), 3 RGB;
    ``colormap`` (n, 3) RGB is written plane by plane (``map_length``
    overrides its length in the header).  Rows are padded to 16 bits;
    ``length`` overrides the header's data length (0 in old files)."""
    pix = np.asarray(pixels)
    h, w = pix.shape[:2]
    if depth < 8:
        bit = (pix.astype(np.uint8).reshape(h, w)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        packed = np.packbits(bit.reshape(h, -1), axis=1)
    elif depth == 8:
        packed = pix.astype(np.uint8).reshape(h, w)
    else:
        order = [0, 1, 2] if kind == 3 else [2, 1, 0]
        ch = pix.astype(np.uint8)[..., order]
        if depth == 32:
            ch = np.concatenate([np.zeros((h, w, 1), np.uint8), ch], axis=-1)
        packed = ch.reshape(h, -1)
    stride = (packed.shape[1] + 1) & ~1
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    body = rows.tobytes()
    if kind == 2:
        body = sunras_rle(body)
    cmap = b""
    if colormap is not None:
        cmap = np.ascontiguousarray(np.asarray(colormap, np.uint8).T).tobytes()
    size = len(body) if length is None else length
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, size, kind, 1 if cmap else 0,
                       len(cmap) if map_length is None else map_length)
    return head + cmap + body


def _hdr_rle(channel: bytes) -> bytes:
    """One scanline channel in Radiance's new-style RLE: runs of 3 to 127
    equal bytes as (128 + n, byte), the rest in literal blocks of up to
    128 bytes (n, bytes...)."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(channel)

    def flush():
        for at in range(0, len(lit), 128):
            block = lit[at:at + 128]
            out.append(len(block))
            out.extend(block)
        lit.clear()

    while i < n:
        run = 1
        while i + run < n and run < 127 and channel[i + run] == channel[i]:
            run += 1
        if run >= 3:
            flush()
            out += bytes((128 + run, channel[i]))
        else:
            lit.extend(channel[i:i + run])
        i += run
    flush()
    return bytes(out)


def encode_hdr(rgbe: np.ndarray, encoding: str = "rle", magic: bytes = b"#?RADIANCE",
               header: Sequence[bytes] = (b"FORMAT=32-bit_rle_rgbe",),
               size_line: Optional[bytes] = None) -> bytes:
    """Radiance HDR bytes of (H, W, 4) uint8 RGBE pixels.  ``encoding``
    "rle" writes each scanline new-style (2, 2, width, then the four
    channels run-length coded), "flat" the pixels as they are, and "old"
    old-style runs (a pixel repeated as (1, 1, 1, count) after it, counts
    of up to 255).  ``magic`` is the first line, ``header`` the lines
    before the blank one, ``size_line`` the resolution line (by default
    "-Y H +X W")."""
    px = np.asarray(rgbe, np.uint8)
    h, w = px.shape[:2]
    out = bytearray(magic + b"\n" + b"".join(line + b"\n" for line in header) + b"\n")
    out += (size_line or f"-Y {h} +X {w}".encode()) + b"\n"
    for row in px:
        if encoding == "rle":
            out += bytes((2, 2, w >> 8, w & 255))
            for c in range(4):
                out += _hdr_rle(row[:, c].tobytes())
        elif encoding == "old":
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 256 and (row[x + run] == row[x]).all():
                    run += 1
                out += row[x].tobytes()
                if run > 1:
                    out += bytes((1, 1, 1, run - 1))
                x += run
        else:
            out += row.tobytes()
    return bytes(out)


#: the committed JPEG-in-TIFF corpus (``tools/port_tiff_jpeg_corpus.py``
#: writes it)
TIFF_JPEG_CORPUS = Path(__file__).resolve().parent.parent / "tests" / "torch_data" / "tiff_jpeg"


def format_variants() -> Dict[str, Tuple[bytes, Tuple[str, ...]]]:
    """The files of the readers' later variants and formats, as
    :func:`image_variants` lists its own (name -> (bytes, modes)): TIFF at
    1, 2, 4, 10, 12 and 14 bits, signed and 32/64-bit integer, 16- and
    64-bit float samples, FillOrder 2 and the predictors libtiff refuses
    on them; the JPEG-in-TIFF corpus; GIF (colour tables, transparency,
    frames off the screen's corner, interlace, animations, LZW resets);
    Sun Raster (each type, depth and colour map); Radiance HDR (new-style
    runs, flat and old-style scanlines, the header's variants).  Each is
    read in both modes; a variant cv2 reads no image from is None in both
    (libtiff's, cv2's refusals, named in the variant)."""
    out: Dict[str, Tuple[bytes, Tuple[str, ...]]] = {}
    h, w = 19, 27
    g8, g16 = variant_image(h, w, 0, np.uint8, 1), variant_image(h, w, 0, np.uint16, 4)
    c16 = variant_image(h, w, 3, np.uint16, 5)
    rng = np.random.default_rng(20)
    full = ((g8.astype(np.int64) - g8.min()) * 255 // max(1, int(np.ptp(g8)))).astype(np.uint8)
    # ---- TIFF: samples below 8 bits (masks)
    mask = (full > 127).astype(np.uint8)
    for comp in (1, 5, 8, 32773):
        for photo in (0, 1):
            out[f"tiff_b1_ph{photo}_c{comp}"] = (encode_tiff(
                mask, bits=1, photometric=photo, compression=comp, rows_per_strip=5), BOTH)
    for bits in (1, 4):
        idx = (full.astype(np.int64) * (1 << bits) // 256).astype(np.uint8)
        for cname, cmap in (("cmap16", rng.integers(0, 65536, (3, 1 << bits))),
                            ("cmap8", rng.integers(0, 256, (3, 1 << bits)))):
            out[f"tiff_b{bits}_palette_{cname}"] = (encode_tiff(
                idx, bits=bits, photometric=3, colormap=cmap.astype(np.uint16),
                compression=5, rows_per_strip=7), BOTH)
        cmap = rng.integers(0, 65536, (3, 1 << bits)).astype(np.uint16)
        out[f"tiff_b{bits}_palette_tiles"] = (encode_tiff(
            idx, bits=bits, photometric=3, colormap=cmap, compression=8, tile=(16, 16)), BOTH)
        out[f"tiff_b{bits}_palette_be_packbits"] = (encode_tiff(
            idx, bits=bits, photometric=3, colormap=cmap, compression=32773,
            big_endian=True), BOTH)
        for o in (3, 6):
            out[f"tiff_b{bits}_orient{o}"] = (encode_tiff(
                idx if bits == 4 else mask, bits=bits, photometric=3 if bits == 4 else 0,
                colormap=cmap if bits == 4 else None, orientation=o, compression=5), BOTH)
            out[f"tiff_b{bits}_orient{o}_tiles"] = (encode_tiff(
                idx if bits == 4 else mask, bits=bits, photometric=3 if bits == 4 else 1,
                colormap=cmap if bits == 4 else None, orientation=o, compression=8,
                tile=(16, 16)), BOTH)
    out["tiff_b1_tiles"] = (encode_tiff(mask, bits=1, compression=5, tile=(16, 16)), BOTH)
    out["tiff_b1_signed"] = (encode_tiff(mask, bits=1, sample_format=2, compression=8), BOTH)
    out["tiff_b1_fill2"] = (encode_tiff(mask, bits=1, compression=5, fill_order=2), BOTH)
    out["tiff_b1_planar2"] = (encode_tiff(mask, bits=1, planar=2, compression=8), BOTH)
    g4 = full >> 4
    out["tiff_none_b2_grey"] = (encode_tiff(full >> 6, bits=2, photometric=1), BOTH)
    out["tiff_none_b2_palette"] = (encode_tiff(full >> 6, bits=2, photometric=3,
                                               colormap=rng.integers(0, 65536, (3, 4)).astype(
                                                   np.uint16)), BOTH)
    out["tiff_none_b4_grey"] = (encode_tiff(g4, bits=4, photometric=1, compression=5), BOTH)
    out["tiff_none_b1_rgb"] = (encode_tiff(np.stack([mask] * 3, -1), bits=1), BOTH)
    out["tiff_none_b1_grey_alpha"] = (encode_tiff(np.stack([mask] * 2, -1), bits=1), BOTH)
    out["tiff_none_b1_predictor2"] = (encode_tiff(mask, bits=1, compression=5, predictor=2),
                                      BOTH)
    out["tiff_none_b1_float"] = (encode_tiff(mask, bits=1, sample_format=3), BOTH)
    # ---- TIFF: 10 to 14 bits (cv2 moves them to the top of 16)
    for bits in (10, 12, 14):
        for name, arr in (("g", g16), ("c", c16)):
            vals = (arr >> (16 - bits)).astype(np.uint16)
            out[f"tiff_b{bits}_{name}_c5"] = (encode_tiff(vals, bits=bits, compression=5,
                                                          rows_per_strip=6), BOTH)
            out[f"tiff_b{bits}_{name}_c1_tiles"] = (encode_tiff(vals, bits=bits,
                                                                tile=(16, 16)), BOTH)
        out[f"tiff_b{bits}_g_signed"] = (encode_tiff((g16 >> (16 - bits)).astype(np.uint16),
                                                     bits=bits, sample_format=2,
                                                     compression=8), BOTH)
        out[f"tiff_b{bits}_g_whiteiszero_orient3"] = (encode_tiff(
            (g16 >> (16 - bits)).astype(np.uint16), bits=bits, photometric=0, orientation=3),
            BOTH)
        out[f"tiff_none_b{bits}_predictor2"] = (encode_tiff(
            (g16 >> (16 - bits)).astype(np.uint16), bits=bits, compression=5, predictor=2),
            BOTH)
    # ---- TIFF: signed, 32/64-bit integer, 16/64-bit float samples (depth)
    wide = g16.astype(np.int64) - 30000
    for dtype in (np.int8, np.int16, np.int32, np.uint32, np.int64, np.uint64, np.float64):
        name = np.dtype(dtype).name
        kind = np.dtype(dtype).kind
        for ch in (0, 3, 4):
            arr = variant_image(h, w, ch, np.uint16, 30 + ch).astype(np.int64) - 30000
            arr = arr.astype(dtype) if kind != "f" else (arr / 7.0).astype(dtype)
            pred = 3 if kind == "f" else 2
            out[f"tiff_{name}_ch{ch}_c8_p{pred}"] = (encode_tiff(
                arr, compression=8, predictor=pred, rows_per_strip=4), BOTH)
            out[f"tiff_{name}_ch{ch}_c5_be"] = (encode_tiff(
                arr, compression=5, big_endian=True, rows_per_strip=7), BOTH)
        arr = wide.astype(dtype) if kind != "f" else (wide / 7.0).astype(dtype)
        out[f"tiff_{name}_tiles_orient6"] = (encode_tiff(
            variant_image(32, 48, 0, np.uint16, 9).astype(np.int64).astype(dtype),
            tile=(16, 16), orientation=6, compression=8), BOTH)
        out[f"tiff_{name}_c32773_whiteiszero"] = (encode_tiff(arr, compression=32773,
                                                              photometric=0), BOTH)
        out[f"tiff_{name}_planar2"] = (encode_tiff(
            variant_image(h, w, 3, np.uint16, 33).astype(np.int64).astype(dtype),
            planar=2, compression=8), ("color",))
        if np.dtype(dtype).itemsize >= 4:
            out[f"tiff_none_{name}_grey_alpha"] = (encode_tiff(
                np.stack([arr, arr], -1), compression=8), BOTH)
    ga16 = variant_image(32, 48, 2, np.uint16, 15).astype(np.int16)
    out["tiff_int16_grey_alpha_tiles"] = (encode_tiff(ga16, compression=5, tile=(16, 16)), BOTH)
    out["tiff_int16_grey_alpha"] = (encode_tiff(ga16, compression=8), BOTH)
    out["tiff_int8_palette"] = (encode_tiff(g8.astype(np.int8), photometric=3,
                                            colormap=rng.integers(0, 65536, (3, 256)).astype(
                                                np.uint16), compression=5), BOTH)
    out["tiff_none_float16"] = (encode_tiff((g16 / 1000.0).astype(np.float16), compression=8),
                                BOTH)
    out["tiff_none_float16_rgb"] = (encode_tiff((c16 / 1000.0).astype(np.float16)), BOTH)
    out["tiff_none_float8"] = (encode_tiff(g8, sample_format=3), BOTH)
    for dtype in (np.uint8, np.int16, np.uint16):
        out[f"tiff_none_{np.dtype(dtype).name}_predictor3"] = (encode_tiff(
            g16.astype(dtype), compression=8, predictor=3), BOTH)
    for comp in (1, 5, 8, 32773):
        out[f"tiff_fill2_g8_c{comp}"] = (encode_tiff(g8, compression=comp, fill_order=2,
                                                     predictor=2 if comp in (5, 8) else 1),
                                         BOTH)
    out["tiff_fill2_c16_c5"] = (encode_tiff(c16, compression=5, fill_order=2, predictor=2),
                                BOTH)
    # ---- JPEG-in-TIFF
    for p in sorted(TIFF_JPEG_CORPUS.glob("*.tif")):
        out[f"tiff_jpeg_{p.stem}"] = (p.read_bytes(), BOTH)
    # ---- GIF
    pal16 = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    pal256 = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx16 = full >> 4
    small = idx16[:7, :9]
    out["gif_plain"] = (encode_gif([idx16], pal16), BOTH)
    out["gif_87a"] = (encode_gif([idx16], pal16, version=b"87a"), BOTH)
    out["gif_256"] = (encode_gif([full], pal256), BOTH)
    out["gif_noise_full_table"] = (encode_gif(
        [rng.integers(0, 256, (61, 97)).astype(np.uint8)], pal256), BOTH)
    out["gif_2colour_mask"] = (encode_gif([mask], np.array([[0, 0, 0], [255, 255, 255]],
                                                           np.uint8)), BOTH)
    out["gif_min_size_8"] = (encode_gif([idx16], pal16, min_size=8), BOTH)
    out["gif_clear_every_7"] = (encode_gif([idx16], pal16, clear_every=7), BOTH)
    out["gif_transparent"] = (encode_gif([{"indices": idx16, "transparent": 3}], pal16,
                                         background=5), BOTH)
    out["gif_transparent_is_background"] = (encode_gif(
        [{"indices": idx16, "transparent": 5}], pal16, background=5), BOTH)
    out["gif_transparent_unused"] = (encode_gif(
        [{"indices": idx16 % 8, "transparent": 12}], pal16), BOTH)
    out["gif_gce_without_transparency"] = (encode_gif(
        [{"indices": idx16, "disposal": 2, "delay": 10}], pal16), BOTH)
    for disposal in (0, 1, 2, 3):
        out[f"gif_offset_disposal{disposal}"] = (encode_gif(
            [{"indices": small, "left": 5, "top": 3, "disposal": disposal}], pal16,
            screen=(w, h), background=5), BOTH)
    out["gif_offset_transparent"] = (encode_gif(
        [{"indices": small, "left": 5, "top": 3, "transparent": 3}], pal16, screen=(w, h),
        background=5), BOTH)
    out["gif_offset_local_only"] = (encode_gif(
        [{"indices": small, "left": 2, "top": 1, "palette": pal16}], None, screen=(w, h),
        background=5), BOTH)
    out["gif_offset_local_only_transparent"] = (encode_gif(
        [{"indices": small, "left": 2, "top": 1, "palette": pal16, "transparent": 3}], None,
        screen=(w, h), background=5), BOTH)
    out["gif_local_and_global"] = (encode_gif(
        [{"indices": small, "left": 2, "top": 1, "palette": pal16[::-1].copy()}], pal16,
        screen=(w, h), background=5), BOTH)
    out["gif_no_colour_table"] = (encode_gif([idx16], None), BOTH)
    for rows in (1, 2, 3, 5, 8, 9, 19):
        out[f"gif_interlaced_{rows}_rows"] = (encode_gif(
            [{"indices": idx16[:rows], "interlace": True}], pal16), BOTH)
    out["gif_interlaced_offset"] = (encode_gif(
        [{"indices": small, "left": 3, "top": 2, "interlace": True}], pal16, screen=(w, h),
        background=5), BOTH)
    out["gif_animation"] = (encode_gif([idx16, 15 - idx16, (idx16 + 3) % 16], pal16), BOTH)
    out["gif_animation_transparent_later"] = (encode_gif(
        [{"indices": small, "left": 2, "top": 1}, {"indices": idx16, "transparent": 3}],
        pal16, screen=(w, h), background=5), BOTH)
    out["gif_none_background_past_table"] = (encode_gif(
        [{"indices": small % 4, "left": 2, "top": 1}], pal16[:4], screen=(w, h),
        background=9), BOTH)
    out["gif_none_frame_past_screen"] = (encode_gif(
        [{"indices": idx16, "left": 4, "top": 3}], pal16, screen=(w, h)), BOTH)
    out["gif_none_index_past_table"] = (encode_gif([idx16], pal16[:4], min_size=4), BOTH)
    out["gif_none_no_frame"] = (b"GIF89a" + struct.pack("<HHBBB", w, h, 0x80, 0, 0)
                                + pal16[:2].tobytes() + b"\x3b", BOTH)
    # ---- Sun Raster
    grey_map = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    c8 = variant_image(h, w, 3, np.uint8, 2)
    for kind in (0, 1):
        for depth, pix, cmap, tag in (
                (8, g8, None, "nomap"), (8, g8, grey_map, "greymap"), (8, g8, pal256, "map"),
                (8, g8 % 100, pal256[:100], "map100"), (1, mask, None, "nomap"),
                (1, mask, pal256[:2], "map"), (1, mask, grey_map[[30, 200]], "greymap"),
                (24, c8, None, "nomap"), (32, c8, None, "nomap")):
            out[f"sunras_t{kind}_d{depth}_{tag}"] = (encode_sunras(pix, depth, kind, cmap),
                                                     BOTH)
    for cols in (1, 2, 9, 16):
        out[f"sunras_d1_{cols}_cols"] = (encode_sunras(mask[:, :cols], 1), BOTH)
        out[f"sunras_d24_{cols}_cols"] = (encode_sunras(c8[:, :cols], 24), BOTH)
    for kind in (2, 3):
        for depth, pix, cmap in ((8, g8, pal256), (24, c8, None), (1, mask, None)):
            out[f"sunras_none_t{kind}_d{depth}"] = (encode_sunras(pix, depth, kind, cmap), BOTH)
    out["sunras_none_d4"] = (encode_sunras(g8 >> 4, 4), BOTH)
    out["sunras_none_map_too_long"] = (encode_sunras(g8, 8, 1, pal256, map_length=769), BOTH)
    out["sunras_none_map_on_24"] = (encode_sunras(c8, 24, 1, pal256[:4]), BOTH)
    # ---- Radiance HDR
    def rgbe(rows, cols, lo=120, hi=140, seed=0):
        r = np.random.default_rng(seed)
        px = r.integers(0, 256, (rows, cols, 4)).astype(np.uint8)
        px[..., 3] = r.integers(lo, hi, (rows, cols))
        px[:, cols // 3:cols // 2] = px[:, cols // 3:cols // 3 + 1]  # runs
        px[1:2] = px[0:1]
        return px

    for enc in ("rle", "flat"):
        for rows, cols in ((h, w), (4, 7), (3, 8), (5, 300)):
            out[f"hdr_{enc}_{rows}x{cols}"] = (encode_hdr(rgbe(rows, cols, seed=cols), enc),
                                               BOTH)
    out["hdr_old_style_runs"] = (encode_hdr(rgbe(h, w), "old"), BOTH)
    flat_old = rgbe(h, w, seed=5)
    flat_old[:, ::2, :3] = 1  # (1, 1, 1, n) pixels without a run to expand
    flat_old[:, ::2, 3] = rng.integers(1, 5, (h, (w + 1) // 2))
    out["hdr_old_style_markers_flat"] = (encode_hdr(flat_old, "flat"), BOTH)
    zeros = rgbe(9, 20)
    zeros[2, 3] = 0
    zeros[4, :, 3] = 0
    out["hdr_zero_exponent"] = (encode_hdr(zeros), BOTH)
    out["hdr_every_exponent"] = (encode_hdr(rgbe(16, 20, 0, 256, 3)), BOTH)
    out["hdr_huge"] = (encode_hdr(rgbe(9, 20, 250, 256, 4)), BOTH)
    out["hdr_unit_range"] = (encode_hdr(rgbe(9, 20, 128, 136, 6)), BOTH)
    out["hdr_rgbe_magic"] = (encode_hdr(rgbe(9, 20), magic=b"#?RGBE"), BOTH)
    out["hdr_exposure_after_format"] = (encode_hdr(rgbe(9, 20), header=(
        b"FORMAT=32-bit_rle_rgbe", b"EXPOSURE=2.0")), BOTH)
    out["hdr_comments_before_format"] = (encode_hdr(rgbe(9, 20), header=(
        b"# made by a test", b"EXPOSURE=2.0", b"GAMMA=2.2", b"FORMAT=32-bit_rle_rgbe")), BOTH)
    out["hdr_long_header_line"] = (encode_hdr(rgbe(9, 20), header=(
        b"# " + b"x" * 200, b"FORMAT=32-bit_rle_rgbe")), BOTH)
    for i, line in enumerate((b"-Y9+X20", b"-Y   9   +X   20 trailing", b"-Y +9 +X +20")):
        out[f"hdr_size_line_{i}"] = (encode_hdr(rgbe(9, 20), size_line=line), BOTH)
    mixed = rgbe(6, 20)
    head = encode_hdr(mixed[:3])
    body_rle = head[head.index(b"+X 20\n") + 6:]
    body_flat = encode_hdr(mixed[3:], "flat")
    body_flat = body_flat[body_flat.index(b"+X 20\n") + 6:]
    out["hdr_rle_then_flat"] = (head[:head.index(b"-Y")] + b"-Y 6 +X 20\n" + body_rle
                                + body_flat, BOTH)
    for i, (kw, tag) in enumerate(((dict(header=(b"EXPOSURE=2.0",)), "no_format"),
                                   (dict(header=(b"FORMAT=32-bit_rle_xyze",)), "xyze"),
                                   (dict(size_line=b"+Y 9 +X 20"), "orientation_plus_y"),
                                   (dict(size_line=b"-Y 9 -X 20"), "orientation_minus_x"),
                                   (dict(size_line=b"+X 20 -Y 9"), "orientation_x_first"),
                                   (dict(size_line=b"-Y 0 +X 20"), "zero_rows"))):
        out[f"hdr_none_{tag}"] = (encode_hdr(rgbe(9, 20), **kw), BOTH)
    trunc = encode_hdr(rgbe(9, 20), "flat")
    out["hdr_none_truncated"] = (trunc[:-5], BOTH)
    return out


# ---------------------------------------------------------------------------
# OpenEXR writing (the structures cv2's writer does not make)
# ---------------------------------------------------------------------------

#: the committed OpenEXR corpus (``tools/port_exr_corpus.py`` writes it)
EXR_CORPUS = Path(__file__).resolve().parent.parent / "tests" / "torch_data" / "exr"
#: OpenEXR's compression names by their header value, and the scanlines of
#: a block under each
EXR_COMPRESSIONS = ("none", "rle", "zips", "zip", "piz", "pxr24", "b44", "b44a", "dwaa",
                    "dwab")
EXR_BLOCK_LINES = (1, 1, 1, 16, 32, 16, 32, 32, 32, 256)
#: OpenEXR's sample types: UINT, HALF, FLOAT
EXR_UINT, EXR_HALF, EXR_FLOAT = 0, 1, 2


def exr_content(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """(h, w, channels) float32 for EXR files: smooth ramps past [0, 1] on
    both sides, noise, and at fixed pixels NaN, +-Inf, float and half
    denormals, -0, the largest half and a value that overflows it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ramp = (x / max(w - 1, 1)) * 1.6 - 0.3 + np.sin(y / 6.0) * 0.25
    out = np.stack([ramp * (1.0 + 0.3 * c) + 0.1 * c for c in range(channels)], axis=-1)
    out = out + rng.normal(0.0, 0.05, out.shape)
    out = out.astype(np.float32)
    specials = [np.nan, np.inf, -np.inf, 1e-40, -1e-40, 3e-6, -0.0, 65504.0, 70000.0, 1e-8,
                -2.5, 17.0]
    flat = out.reshape(-1, channels)
    for i, v in enumerate(specials):
        at = (i * 7919 + 13) % flat.shape[0]
        flat[at, i % channels] = v
    return out


def _exr_attr(name: str, kind: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value


def _exr_preprocess(raw: bytes) -> bytes:
    """ZIP's and RLE's reordering (even bytes, then odd ones) and byte
    predictor (each the difference to the one before, plus 128)."""
    a = np.frombuffer(raw, np.uint8)
    t = np.concatenate([a[0::2], a[1::2]]).astype(np.int32)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 255
    return d.astype(np.uint8).tobytes()


def _exr_rle(data: bytes) -> bytes:
    """OpenEXR's run-length coding: a run of 3 to 128 equal bytes as its
    length less one and the byte, else up to 127 literal bytes after their
    negated count."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i + 1
        while j < n and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += struct.pack("b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def _exr_float24(f: np.ndarray) -> np.ndarray:
    """PXR24's float to 24 bits (``floatToFloat24``)."""
    u = f.astype(np.float32).view(np.uint32).astype(np.int64)
    s, e, m = u & 0x80000000, u & 0x7F800000, u & 0x007FFFFF
    nan = (m >> 8) | ((m >> 8) == 0)
    special = np.where(m != 0, (e >> 8) | nan, e >> 8)
    i = ((e | m) + (m & 0x80)) >> 8
    i = np.where(i >= 0x7F8000, (e | m) >> 8, i)
    return ((s >> 8) | np.where(e == 0x7F800000, special, i)).astype(np.int64)


def _exr_samples(arr: np.ndarray, kind: int) -> np.ndarray:
    if kind == EXR_UINT:
        return np.asarray(arr).astype(np.uint32)
    with np.errstate(over="ignore"):  # past the largest half: +-Inf, as OpenEXR converts
        return np.asarray(arr).astype(np.float16 if kind == EXR_HALF else np.float32)


def _exr_compress(lines, compression: int, names=(), dwa=None, linear=()) -> bytes:
    """One block: ``lines`` is a list of scanlines, each a list of (kind,
    samples) per channel.  Stored raw where the coding does not shrink
    it, as OpenEXR stores it."""
    raw = b"".join(s.astype(s.dtype.newbyteorder("<")).tobytes()
                   for line in lines for _, s in line)
    if compression == 0:
        return raw
    if compression == 1:
        coded = _exr_rle(_exr_preprocess(raw))
    elif compression in (2, 3):
        coded = zlib.compress(_exr_preprocess(raw), 9)
    elif compression in (8, 9):
        coded = _exr_dwa(lines, names, dwa or {}, linear)
    elif compression == 5:
        planes = []
        for line in lines:
            for kind, s in line:
                if kind == EXR_UINT:
                    u, shifts = s.astype(np.int64), (24, 16, 8, 0)
                elif kind == EXR_HALF:
                    u, shifts = s.view(np.uint16).astype(np.int64), (8, 0)
                else:
                    u, shifts = _exr_float24(s), (16, 8, 0)
                d = np.diff(u, prepend=0) & 0xFFFFFFFF
                planes += [((d >> k) & 255).astype(np.uint8) for k in shifts]
        coded = zlib.compress(np.concatenate(planes).tobytes() if planes else b"", 9)
    else:
        raise ValueError(f"the test writer does not code {EXR_COMPRESSIONS[compression]}")
    return coded if len(coded) < len(raw) else raw


#: OpenEXR 2.2+'s default DWA channel rules: (suffix, scheme 1 lossy DCT
#: / 2 RLE, sample type, CSC index)
EXR_DWA_RULES = tuple((n, 1, t, i) for n, i in (("R", 0), ("G", 1), ("B", 2), ("Y", -1),
                                                 ("BY", -1), ("RY", -1)) for t in (1, 2)) \
    + tuple(("A", 2, t, -1) for t in (0, 1, 2))
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def exr_huf_encode(values: np.ndarray) -> bytes:
    """OpenEXR's Huffman coding (``hufCompress``'s format) of unsigned
    shorts: the 20-byte header (smallest and run symbol, table length,
    bit count), the code lengths packed six bits each with zero runs, the
    canonical codes (longest first), and runs of 4 or more of a value as
    the value, then the run symbol (the largest value plus one) and an
    8-bit count."""
    import heapq
    from collections import Counter

    vals = [int(v) for v in np.asarray(values).ravel()]
    if not vals:
        return b""
    im, rlc = min(vals), max(vals) + 1
    tokens = []  # (symbol, extra run count or None)
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and vals[j + 1] == vals[i]:
            j += 1
        tokens.append((vals[i], None))
        extra = j - i
        if extra >= 3:
            while extra:
                k = min(extra, 255)
                tokens.append((rlc, k))
                extra -= k
        else:
            tokens += [(vals[i], None)] * extra
        i = j + 1
    freq = Counter(t for t, _ in tokens)
    freq[rlc] = freq.get(rlc, 0) + 1
    heap = [(f, k, (sym,)) for k, (sym, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    lengths = dict.fromkeys(freq, 0)
    if len(heap) == 1:
        lengths[heap[0][2][0]] = 1
    count = len(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for sym in s1 + s2:
            lengths[sym] += 1
        heapq.heappush(heap, (f1 + f2, count, s1 + s2))
        count += 1
    assert max(lengths.values()) <= 58
    n = [0] * 59
    for ln in lengths.values():
        n[ln] += 1
    start, c = [0] * 59, 0
    for ln in range(58, 0, -1):
        start[ln], c = c, (c + n[ln]) >> 1
    codes = {}
    for sym in sorted(lengths):
        codes[sym] = start[lengths[sym]]
        start[lengths[sym]] += 1
    bits = []

    def put(value, nbits):
        bits.extend((value >> (nbits - 1 - k)) & 1 for k in range(nbits))

    sym = im
    while sym <= rlc:
        ln = lengths.get(sym, 0)
        if ln == 0:
            run = 1
            while sym + run <= rlc and lengths.get(sym + run, 0) == 0 and run < 255 + 6:
                run += 1
            if run >= 2:
                if run >= 6:
                    put(63, 6)
                    put(run - 6, 8)
                else:
                    put(59 + run - 2, 6)
                sym += run
                continue
        put(ln, 6)
        sym += 1
    table = np.packbits(np.array(bits, np.uint8)).tobytes() if bits else b""
    bits = []
    for tok, extra in tokens:
        put(codes[tok], lengths[tok])
        if extra is not None:
            put(extra, 8)
    data = np.packbits(np.array(bits, np.uint8)).tobytes()
    return struct.pack("<5I", im, rlc, len(table), len(bits), 0) + table + data


def _exr_dwa(lines, names, opts, linear=()) -> bytes:
    """A DWAA/DWAB block (version 2) of unsampled channels.  ``opts``:
    'rules' (default ``EXR_DWA_RULES``; () puts every channel in the
    lossless UNKNOWN scheme, zlib of its samples), 'ac' ('huffman', the
    default, or 'deflate').  A lossy channel's values are made nonlinear (as
    OpenEXR's ``toNonlinear``, in float64; not for a single channel in
    ``linear``), then the 8x8 blocks (edges repeated) of each plane, or of
    the Y'CbCr of an R/G/B set, go through the orthonormal DCT, rounded to
    half, AC coefficients below 0.02 dropped, zig-zag run-coded (0xffNN skips
    NN zeros, 0xff00 ends the block); the DC values are ZIP-coded, the AC
    Huffman- or zlib-coded.  A-channels (RLE scheme): byte planes,
    OpenEXR's run-length code, zlib."""
    if any(len(line) != len(lines[0]) for line in lines):
        raise ValueError("the test writer codes DWA on unsampled channels only")
    rules = EXR_DWA_RULES if opts.get("rules") is None else opts["rules"]
    planes = [np.stack([line[k][1] for line in lines]) for k in range(len(names))]
    kinds = [lines[0][k][0] for k in range(len(names))]
    schemes, prefixes = [], {}
    for k, name in enumerate(names):
        prefix, _, suffix = name.rpartition(".")
        slots = prefixes.setdefault(prefix, [-1, -1, -1])
        scheme = 0
        for rule_suffix, rule_scheme, kind, csc in rules:
            if suffix == rule_suffix and kind == kinds[k]:
                scheme = rule_scheme
                if csc >= 0:
                    slots[csc] = k
        schemes.append(scheme)
    sets = [tuple(v) for _, v in sorted(prefixes.items()) if min(v) >= 0]
    in_sets = {k for group in sets for k in group}
    m = np.array([[0.5 * (np.sqrt(0.5) if k == 0 else 1.0) * np.cos((2 * n + 1) * k * np.pi / 16)
                   for n in range(8)] for k in range(8)])
    ac_tokens, dc_planes = [], []

    def lossy(comps):
        h, w = comps[0].shape
        bh, bw = -(-h // 8) * 8, -(-w // 8) * 8
        padded = [np.pad(np.nan_to_num(c.astype(np.float64), nan=0.0, posinf=4.0,
                                       neginf=-4.0), ((0, bh - h), (0, bw - w)), mode="edge")
                  for c in comps]
        blocks = np.stack([p.reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
                           .reshape(-1, 8, 8) for p in padded], axis=1)
        coef = m @ blocks @ m.T
        with np.errstate(over="ignore"):
            zz = coef.reshape(coef.shape[0], len(comps), 64)[..., _ZIGZAG].astype(np.float16)
        zz[..., 1:][np.abs(zz[..., 1:].astype(np.float64)) < 0.02] = 0  # runs of zeros
        zz = np.where(np.isfinite(zz), zz, np.float16(0)).view(np.uint16)
        dc_planes.extend(zz[:, c, 0] for c in range(len(comps)))
        for blk in zz:
            for comp in blk:
                run = 0
                for v in comp[1:].tolist():
                    if v == 0:
                        run += 1
                        continue
                    if run:
                        ac_tokens.append(0xFF00 | run)
                        run = 0
                    ac_tokens.append(v)
                if run:
                    ac_tokens.append(0xFF00)

    def nonlinear(v):
        """OpenEXR's ``toNonlinear`` in float64: |v| ** (1 / 2.2) up to 1,
        ln |v| / 2.2 + 1 past it, the sign kept."""
        v = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=65504.0, neginf=-65504.0)
        a = np.abs(v)
        with np.errstate(divide="ignore"):
            out = np.where(a <= 1, a ** (1 / 2.2), np.log(np.maximum(a, 1)) / 2.2 + 1)
        return np.sign(v) * out

    for group in sets:  # taken as nonlinear whatever their flags, as OpenEXR does
        r, g, b = (nonlinear(planes[k]) for k in group)
        y = (g + 0.1873 / 1.8556 * b + 0.4682 / 1.5747 * r) / (
            1 + 0.1873 / 1.8556 + 0.4682 / 1.5747)
        lossy([y, (b - y) / 1.8556, (r - y) / 1.5747])
    for k in range(len(names)):
        if schemes[k] == 1 and k not in in_sets:
            lossy([planes[k].astype(np.float64) if names[k] in linear else
                   nonlinear(planes[k])])
    unknown = b"".join(planes[k].astype(planes[k].dtype.newbyteorder("<")).tobytes()
                       for k in range(len(names)) if schemes[k] == 0)
    rle_raw = b"".join(np.ascontiguousarray(
        planes[k].astype(planes[k].dtype.newbyteorder("<")).view(np.uint8).reshape(
            -1, planes[k].dtype.itemsize).T).tobytes()
        for k in range(len(names)) if schemes[k] == 2)
    dc = np.concatenate(dc_planes).astype("<u2").tobytes() if dc_planes else b""
    ac = np.asarray(ac_tokens, np.uint16)
    ac_mode = 1 if opts.get("ac") == "deflate" else 0
    ac_coded = (zlib.compress(ac.astype("<u2").tobytes(), 9) if ac_mode
                else exr_huf_encode(ac)) if len(ac) else b""
    unk_coded = zlib.compress(unknown, 9) if unknown else b""
    dc_coded = zlib.compress(_exr_preprocess(dc), 9) if dc else b""
    rle_coded = _exr_rle(rle_raw) if rle_raw else b""
    rle_zipped = zlib.compress(rle_coded, 9) if rle_raw else b""
    rule_bytes = b"".join(suffix.encode() + b"\0" + bytes([((csc + 1) << 4) | (scheme << 2),
                                                           kind])
                          for suffix, scheme, kind, csc in rules)
    head = struct.pack("<11Q", 2, len(unknown), len(unk_coded), len(ac_coded), len(dc_coded),
                       len(rle_zipped), len(rle_coded), len(rle_raw), len(ac),
                       len(dc) // 2, ac_mode)
    return (head + struct.pack("<H", 2 + len(rule_bytes)) + rule_bytes + unk_coded + ac_coded
            + dc_coded + rle_zipped)


def _exr_levels(w: int, h: int, mode: int, rounding: int):
    """The (lx, ly, width, height) of every level of a tiled part, in the
    offset table's order."""
    def log2(n):
        k = 0
        while (1 << (k + 1)) <= n:
            k += 1
        return k + (rounding == 1 and (1 << k) < n)

    def size(n, lv):
        return max(((n + (1 << lv) - 1) if rounding else n) >> lv, 1)

    if mode == 0:
        return [(0, 0, w, h)]
    if mode == 1:
        return [(lv, lv, size(w, lv), size(h, lv)) for lv in range(log2(max(w, h)) + 1)]
    return [(lx, ly, size(w, lx), size(h, ly)) for ly in range(log2(h) + 1)
            for lx in range(log2(w) + 1)]


def _exr_part(channels, compression=0, types=None, sampling=None, line_order=0,
              origin=(0, 0), display=None, tile=None, attrs=(), name=None, deep=False,
              dwa=None, linear=()):
    """One part: (header bytes without its end, chunks in table order,
    the order the chunks are written in)."""
    names = sorted(channels)
    types = {n: (types or {}).get(n, EXR_HALF) for n in names}
    sampling = {n: (sampling or {}).get(n, (1, 1)) for n in names}
    xs0, ys0 = sampling[names[0]]
    h = channels[names[0]].shape[0] * ys0
    w = channels[names[0]].shape[1] * xs0
    x0, y0 = origin
    chl = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", types[n], n in linear,
                                                    *sampling[n]) for n in names) + b"\0"
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    disp = box if display is None else struct.pack("<iiii", *display)
    head = [_exr_attr("channels", "chlist", chl),
            _exr_attr("compression", "compression", bytes([compression])),
            _exr_attr("dataWindow", "box2i", box),
            _exr_attr("displayWindow", "box2i", disp),
            _exr_attr("lineOrder", "lineOrder", bytes([line_order])),
            _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))]
    samples = {n: _exr_samples(channels[n], types[n]) for n in names}
    chunks = []
    if deep:
        for y in range(h):
            counts = np.full(w, 1, np.int32)
            table = np.cumsum(counts).astype("<i4").tobytes()
            data = b"".join(samples[n][y].astype(samples[n].dtype.newbyteorder("<")).tobytes()
                            for n in names)
            chunks.append(struct.pack("<iqqq", y0 + y, len(table), len(data), len(data))
                          + table + data)
        head += [_exr_attr("type", "string", b"deepscanline"),
                 _exr_attr("version", "int", struct.pack("<i", 1)),
                 _exr_attr("maxSamplesPerPixel", "int", struct.pack("<i", 1))]
    elif tile is None:
        step = EXR_BLOCK_LINES[compression]
        for b0 in range(0, h, step):
            lines = []
            for y in range(b0, min(b0 + step, h)):
                line = []
                for n in names:
                    xs, ys = sampling[n]
                    if (y0 + y) % ys == 0:
                        line.append((types[n], samples[n][(y0 + y) // ys - y0 // ys]))
                lines.append(line)
            data = _exr_compress(lines, compression, names, dwa, linear)
            chunks.append(struct.pack("<ii", y0 + b0, len(data)) + data)
    else:
        tx, ty, mode, rounding = tile
        head.append(_exr_attr("tiles", "tiledesc", struct.pack("<IIB", tx, ty,
                                                               mode | rounding << 4)))
        for lx, ly, lw, lh in _exr_levels(w, h, mode, rounding):
            level = {n: samples[n][::1 << ly, ::1 << lx][:lh, :lw] for n in names}
            for j in range(-(-lh // ty)):
                for i in range(-(-lw // tx)):
                    lines = [[(types[n], level[n][r, i * tx:(i + 1) * tx]) for n in names]
                             for r in range(j * ty, min((j + 1) * ty, lh))]
                    data = _exr_compress(lines, compression, names, dwa, linear)
                    chunks.append(struct.pack("<iiiii", i, j, lx, ly, len(data)) + data)
    if name is not None:
        kind = "tiledimage" if tile is not None else "scanlineimage"
        head += [_exr_attr("name", "string", name.encode()),
                 _exr_attr("type", "string", kind.encode()),
                 _exr_attr("chunkCount", "int", struct.pack("<i", len(chunks)))]
    head += [_exr_attr(*a) for a in attrs]
    order = list(range(len(chunks)))
    if line_order == 1:
        if tile is None:
            order = order[::-1]
        else:  # each level's rows of tiles from the bottom
            order, at = [], 0
            for lx, ly, lw, lh in _exr_levels(w, h, tile[2], tile[3]):
                nx, ny = -(-lw // tile[0]), -(-lh // tile[1])
                order += [at + j * nx + i for j in range(ny - 1, -1, -1) for i in range(nx)]
                at += nx * ny
    elif line_order == 2:
        order = [int(i) for i in np.random.default_rng(len(chunks)).permutation(len(chunks))]
    return b"".join(head), chunks, order


def encode_exr(channels: Dict[str, np.ndarray], compression: int = 0, types=None,
               sampling=None, line_order: int = 0, origin=(0, 0), display=None, tile=None,
               attrs=(), long_names: bool = False, deep: bool = False,
               parts: Optional[Sequence[Dict]] = None, dwa=None, linear=()) -> bytes:
    """An OpenEXR file of ``channels`` (name -> (rows, columns) samples,
    each its channel's sample grid): ``types`` name -> ``EXR_UINT``/
    ``EXR_HALF`` (the default)/``EXR_FLOAT``, ``sampling`` name -> (x, y)
    subsampling, ``compression`` an index of ``EXR_COMPRESSIONS`` (none,
    RLE, ZIPS, ZIP and PXR24 are coded, and DWAA/DWAB on unsampled
    channels as :func:`_exr_dwa` says, ``dwa`` its options; a block not
    shrunk is stored raw), ``linear`` the names flagged perceptually
    linear, ``line_order`` 0 increasing, 1 decreasing, 2 random (tiles
    only), ``origin`` the data window's corner, ``display`` the display
    window (xmin, ymin, xmax, ymax; the data window by default), ``tile``
    (x size, y size, level mode 0/1/2 one/mip/rip, rounding 0 down/1 up),
    ``attrs`` more (name, type, value bytes) attributes, ``long_names``
    the version flag for names past 31 bytes, ``deep`` one sample a pixel
    as a deep scanline file.  ``parts`` (keyword dicts of the above, each
    with its ``name``) writes a multi-part file instead."""
    if parts is None:
        parts = [dict(channels=channels, compression=compression, types=types,
                      sampling=sampling, line_order=line_order, origin=origin,
                      display=display, tile=tile, attrs=attrs, deep=deep, dwa=dwa,
                      linear=linear)]
        flags = (0x200 if tile is not None else 0) | (0x800 if deep else 0)
    else:
        flags = 0x1000
    flags |= 0x400 if long_names else 0
    built = [_exr_part(**p) for p in parts]
    multi = len(parts) > 1 or flags & 0x1000
    head = b"v/1\x01" + struct.pack("<I", 2 | flags)
    head += b"".join(h + b"\0" for h, _, _ in built) + (b"\0" if multi else b"")
    at = len(head) + 8 * sum(len(c) for _, c, _ in built)
    offsets, body = [], []
    for index, (_, chunks, order) in enumerate(built):
        prefix = struct.pack("<i", index) if multi else b""
        table = [0] * len(chunks)
        for k in order:
            table[k] = at
            body.append(prefix + chunks[k])
            at += len(prefix) + len(chunks[k])
        offsets.append(struct.pack(f"<{len(table)}Q", *table))
    return head + b"".join(offsets) + b"".join(body)


def exr_variants() -> Dict[str, Tuple[bytes, Tuple[str, ...]]]:
    """The OpenEXR corpus as :func:`image_variants` lists its files:
    "exr_" and the file's stem -> (bytes, both modes): cv2 4.13's own
    files (``cv2_*``, every compression, half and float, 1, 3 and 4
    channels) and this module's (``np_*``: tiles and levels, line orders,
    windows, sample types, channel layouts, chroma, multi-part, deep and
    truncated files)."""
    return {f"exr_{p.stem}": (p.read_bytes(), BOTH) for p in sorted(EXR_CORPUS.glob("*.exr"))}
