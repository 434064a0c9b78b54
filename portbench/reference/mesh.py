"""The meshes of the configurations, made or read by the benchmark itself.

``icosphere`` builds the bench protocol's sphere, ``read_ply`` reads an
ascii PLY of vertices, uchar colours and triangles, and ``edge_adjacency``
is the per-edge neighbour table that tells silhouette edges apart.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def icosphere(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: (N, 3) float32 vertices, (T, 3) int32 faces, 20 * 4**subdiv
    triangles, each subdivision splitting every face in four at its edges'
    midpoints pushed out to the sphere."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    v /= np.linalg.norm(v[0])
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        cache: Dict[Tuple[int, int], int] = {}
        verts = list(map(tuple, v))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                cache[key] = len(verts)
                verts.append(tuple(m / np.linalg.norm(m)))
            return cache[key]

        faces = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts, np.float64), np.asarray(faces, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def edge_adjacency(faces: np.ndarray) -> np.ndarray:
    """(T, 3) int32: [t, k] the triangle sharing edge (faces[t, k],
    faces[t, (k + 1) % 3]) with t, -1 where no or more than one other
    triangle shares it."""
    faces = np.asarray(faces, np.int64)
    t = len(faces)
    a = faces.reshape(-1)
    b = np.roll(faces, -1, axis=1).reshape(-1)
    key = np.minimum(a, b) * (int(faces.max()) + 1) + np.maximum(a, b)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    start = np.r_[0, np.flatnonzero(ks[1:] != ks[:-1]) + 1]
    size = np.diff(np.r_[start, len(ks)])
    adj = np.full(3 * t, -1, np.int64)
    pairs = start[size == 2]
    e0, e1 = order[pairs], order[pairs + 1]
    adj[e0], adj[e1] = e1 // 3, e0 // 3
    return adj.reshape(t, 3).astype(np.int32)


def read_ply(path) -> Dict[str, np.ndarray]:
    """An ascii PLY's 'vertices' (N, 3) float32, 'colors' (N, 3) float32 in
    [0, 1] (uchar / 255) and 'faces' (T, 3) int32 (triangles only)."""
    lines = Path(path).read_text().splitlines()
    if lines[0].strip() != "ply" or "ascii" not in lines[1]:
        raise ValueError(f"{path}: not an ascii PLY")
    n_vert = n_face = 0
    props = []
    end = 0
    for i, line in enumerate(lines):
        words = line.split()
        if words[:2] == ["element", "vertex"]:
            n_vert = int(words[2])
        elif words[:2] == ["element", "face"]:
            n_face = int(words[2])
        elif words[:1] == ["property"] and n_face == 0:
            props.append(words[-1])
        elif words[:1] == ["end_header"]:
            end = i + 1
            break
    rows = np.array([line.split() for line in lines[end:end + n_vert]], np.float64)
    col = {name: rows[:, i] for i, name in enumerate(props)}
    verts = np.stack([col["x"], col["y"], col["z"]], axis=1).astype(np.float32)
    colors = (np.stack([col["red"], col["green"], col["blue"]], axis=1).astype(np.float32)
              / np.float32(255.0))
    faces = np.array([line.split()[1:4] for line in lines[end + n_vert:end + n_vert + n_face]],
                     np.int32)
    return {"vertices": verts, "colors": colors, "faces": faces}
