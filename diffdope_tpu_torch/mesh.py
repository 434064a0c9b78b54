"""Mesh topology helpers (numpy only).

Counterpart of ``diffdope_tpu/mesh.py:build_edge_adjacency`` — its
numpy/dict path, copied so the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def build_edge_adjacency(faces: np.ndarray) -> np.ndarray:
    """Per-edge neighbour triangle map for silhouette classification.

    Returns (T, 3) int32: entry [t, k] is the index of the triangle sharing
    edge (faces[t,k], faces[t,(k+1)%3]) with triangle t, or -1 for boundary
    (or non-manifold) edges.
    """
    faces = np.asarray(faces)
    t = len(faces)
    adj = np.full((t, 3), -1, dtype=np.int32)
    edge_map: dict = {}
    for ti in range(t):
        f = faces[ti]
        for k in range(3):
            a, b = int(f[k]), int(f[(k + 1) % 3])
            key = (min(a, b), max(a, b))
            edge_map.setdefault(key, []).append((ti, k))
    for users in edge_map.values():
        if len(users) == 2:
            (t0, k0), (t1, k1) = users
            adj[t0, k0] = t1
            adj[t1, k1] = t0
    return adj
