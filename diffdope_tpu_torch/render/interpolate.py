"""Barycentric attribute interpolation with the nvdiffrast ``interpolate``
contract (plain torch).

Counterpart of ``diffdope_tpu/render/interpolate.py``: at every foreground
pixel the three vertex attributes of its triangle blend with the
perspective-correct barycentrics of ``rast``,

    out = a0 * (1 - u - v) + a1 * u + a2 * v,

differentiable in the attributes (the gather's backward sums each vertex's
pixels in ascending pixel order, ``rasterize.IndexRows``: the same bits
from call to call on the card) and in the (u, v) channels of ``rast`` (and
through them the clip positions).  With ``diff_attrs`` also the image-space
derivatives J_attr . (du/dx, du/dy, dv/dx, dv/dy).  Background is 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.render.rasterize import IndexRows


def interpolate(
    attr,
    rast: torch.Tensor,
    tri,
    rast_db: Optional[torch.Tensor] = None,
    diff_attrs: Union[None, str, Sequence[int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Interpolate vertex attributes at rasterized pixels
    (``interpolate.py:30-94``).

    Args:
        attr: (N, C) or (B, N, C) vertex attributes (differentiable; numpy
            goes to ``rast``'s device).
        rast: (B, H, W, 4) rasterizer output (u, v, z/w, id).
        tri: (T, 3) triangle indices.
        rast_db: (B, H, W, 4) barycentric pixel derivatives, needed for
            ``diff_attrs``.
        diff_attrs: 'all' or a list of attribute channels whose image-space
            derivatives to return.

    Returns (out (B, H, W, C), out_da (B, H, W, 2*D) laid out (dA_0/dx,
    dA_0/dy, dA_1/dx, ...) or None without ``diff_attrs``).
    """
    b, h, w, _ = rast.shape
    attr = tensor(attr, rast.device)
    tri = tensor(tri, rast.device, torch.int64)
    if attr.dim() == 2:
        attr = attr[None].expand((b,) + tuple(attr.shape))
    n_ch = attr.shape[-1]

    ids = rast[..., 3].detach().to(torch.int64)  # 0 = background
    fg = (ids > 0)[..., None]
    corners = tri[(ids - 1).clamp(min=0)]  # (B, H, W, 3) vertex indices
    # background pixels read triangle 0's corners; their outputs are masked,
    # so they take no part in the gradient's sums
    a = IndexRows.apply(attr, corners.reshape(b, -1),
                   fg.expand(-1, -1, -1, 3).reshape(b, -1)).reshape(b, h, w, 3, n_ch)

    u = rast[..., 0:1]
    v = rast[..., 1:2]
    w0 = (1.0 - u) - v
    out = (a[..., 0, :] * w0 + a[..., 1, :] * u) + a[..., 2, :] * v
    out = torch.where(fg, out, torch.zeros_like(out))
    if diff_attrs is None:
        return out, None
    if rast_db is None:
        raise ValueError("diff_attrs requires rast_db")
    if isinstance(diff_attrs, str):
        if diff_attrs != "all":
            raise ValueError("diff_attrs must be 'all' or a channel list")
        sel = list(range(n_ch))
    else:
        sel = list(diff_attrs)

    # dA/du = a1 - a0, dA/dv = a2 - a0, chained with the pixel derivatives
    da_du = a[..., 1, :] - a[..., 0, :]
    da_dv = a[..., 2, :] - a[..., 0, :]
    dadx = da_du * rast_db[..., 0:1] + da_dv * rast_db[..., 2:3]
    dady = da_du * rast_db[..., 1:2] + da_dv * rast_db[..., 3:4]
    # channel by channel: a list index would copy host data to the device
    out_da = torch.stack([d[..., c] for c in sel for d in (dadx, dady)], dim=-1)
    return out, torch.where(fg, out_da, torch.zeros_like(out_da))
