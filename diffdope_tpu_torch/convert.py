"""Carry the reference's state across to the port.

The system has no weights: its state is the pose parameters {qx..z} (B,),
the mesh (pos, tri, edge_adj, vtx_color or corner_colors), the gt images,
the per-hypothesis loss scales and the projection.  :func:`state` takes
the JAX package's inputs as numpy arrays (``np.asarray`` of a jax array
works), nested in dicts as the reference passes them, and returns the
port's tensors on a given device, so both packages compute from
identical inputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: keys of integer arrays (triangle and neighbour indices); all else is float32
INDEX_KEYS = ("tri", "pos_idx", "edge_adj")


def tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    """numpy / array-like / tensor -> a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def state(arrays: Dict[str, object], device) -> Dict[str, object]:
    """A (nested) dict of reference inputs -> the same dict of tensors:
    int64 for the index arrays (``INDEX_KEYS``), float32 for the rest;
    None entries stay None."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out[k] = state(v, device)
        elif v is None:
            out[k] = None
        else:
            out[k] = tensor(v, device, torch.int64 if k in INDEX_KEYS else torch.float32)
    return out
