"""Carry the reference's state across to the port.

The system has no weights: its state is the pose parameters {qx..z} (B,),
the mesh (pos, tri, edge_adj, its colours: vtx_color, or a texture with
its uv, uv_idx and baked corner_colors), the gt images,
the per-hypothesis loss scales and the projection.  :func:`state` takes
the JAX package's inputs as numpy arrays (``np.asarray`` of a jax array
works), nested in dicts as the reference passes them, and returns the
port's tensors on a given device, so both packages compute from
identical inputs.  :func:`diffdope_state` reads the same state off a
reference ``DiffDope`` session.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: keys of integer arrays (triangle and neighbour indices); all else is float32
INDEX_KEYS = ("tri", "pos_idx", "edge_adj", "uv_idx")


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


def _plain(value):
    """A (nested) config mapping as plain dicts and lists."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def diffdope_state(dd) -> Dict[str, object]:
    """A reference ``DiffDope``'s state as numpy: the mesh arrays ('pos',
    'pos_idx', 'edge_adj', each colour array the mesh has: 'vtx_color',
    'corner_colors', and 'tex' with 'uv' and 'uv_idx'; 'is_closed',
    'is_oriented'), the projection 'proj', the initial pose 'params0'
    (seven (B,) arrays), the loss scales 'learning_rates', the gt arrays
    'gt' (its 'depth' too, where the scene has one), and the config groups
    that choose the losses and the table, 'losses' and 'tpu', as plain
    dicts.  Read by attribute only, so this module needs no jax: a port
    ``DiffDope`` built from these computes the same refinement."""
    mesh = dd.object3d.mesh
    out = {
        "pos": np.asarray(mesh.pos),
        "pos_idx": np.asarray(mesh.pos_idx),
        "edge_adj": None if mesh.edge_adj is None else np.asarray(mesh.edge_adj),
        "is_closed": bool(mesh.is_closed),
        "is_oriented": bool(mesh.is_oriented),
        "proj": np.asarray(dd.camera.cam_proj),
        "params0": {k: np.asarray(v)
                    for k, v in dd.object3d.initial_params(dd.batchsize).items()},
        "learning_rates": np.asarray(dd.learning_rates),
        "gt": {k: np.asarray(v) for k, v in dd.gt_tensors.items()},
        "losses": _plain(dd.cfg.get("losses", {})),
        "tpu": _plain(dd.cfg.get("tpu", {})),
    }
    for key in ("vtx_color", "corner_colors", "tex", "uv", "uv_idx"):
        if getattr(mesh, key) is not None:
            out[key] = np.asarray(getattr(mesh, key))
    return out
