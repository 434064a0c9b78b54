"""Synthetic scenes for tests, the bench and the chip smoke run (numpy only).

Counterpart of ``diffdope_tpu/testing.py``: the same procedural icosphere
(copied, not imported — importing the JAX package pulls in jax), the
bench protocol's scene as plain numpy arrays, and the textured stand-in
builder.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
