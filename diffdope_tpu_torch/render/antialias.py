"""Analytic silhouette-edge antialiasing with the nvdiffrast ``antialias``
contract (plain torch).

Counterpart of ``diffdope_tpu/render/antialias.py``: the only path by which
pixel coverage gives a gradient to the vertex positions (reference
``diffdope.py:214``).  For every pair of adjacent pixels whose triangle ids
differ, the foreground triangle's edge crossing of the segment between the
two pixel centres, at lambda in [0, 1], blends the pair by how far it
overhangs the midpoint:

    lambda > 1/2: bg += (lambda - 1/2) * (c_fg - c_bg)
    lambda < 1/2: fg += (1/2 - lambda) * (c_bg - c_fg)

lambda is a differentiable function of the edge's corner positions.  The
foreground of a pair is its covered pixel, or the nearer one (smaller z/w)
when both are.  With ``edge_adj`` only silhouette edges blend: boundary
edges and front/back facing transitions.

Tie rules follow JAX, whose gradients the reference takes: ``torch.amin`` /
``torch.amax`` split a gradient evenly among tied lambdas as ``jnp.min`` /
``jnp.max`` do, and ``jnp.clip`` / ``jnp.maximum`` split it 0.5/0.5 at the
bound (``torch.minimum`` / ``torch.maximum``, never ``torch.clamp``).
"""

from __future__ import annotations

from typing import Optional

import torch

from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.render.rasterize import IndexRows, gather_rows
from diffdope_tpu_torch.render.shade import ndc

_EPS = 1e-12


class _BoostGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``boost`` (the
    reference's ``custom_vjp``, ``antialias.py:86-101``)."""

    @staticmethod
    def forward(ctx, x, boost):
        ctx.boost = boost
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.boost, None


def antialias(
    color: torch.Tensor,
    rast: torch.Tensor,
    pos_clip: Optional[torch.Tensor],
    tri,
    pos_gradient_boost: float = 1.0,
    edge_adj=None,
    corners_clip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Antialias ``color`` along silhouette edges (``antialias.py:44-148``).

    Args:
        color: (B, H, W, C) rendered image (differentiable).
        rast: (B, H, W, 4) rasterizer output (ids and z/w; no gradient).
        pos_clip: (B, N, 4) clip positions (differentiable); may be None
            when ``corners_clip`` (B, T, 3, 4) is given.
        tri: (T, 3) triangle indices.
        pos_gradient_boost: scale on the position gradient.
        edge_adj: optional (T, 3) neighbour triangle per edge
            (``mesh.build_edge_adjacency``, -1 = boundary).

    Returns the (B, H, W, C) antialiased image.
    """
    b, h, w, _ = color.shape
    dev = color.device
    tri = tensor(tri, dev, torch.int64)
    ids = rast[..., 3].detach().to(torch.int64)
    zw = rast[..., 2].detach()

    if corners_clip is not None:
        src = tensor(corners_clip, dev).reshape(b, -1, 4)  # (B, 3T, 4)
    else:
        src = gather_rows(tensor(pos_clip, dev), tri.reshape(-1))  # (B, 3T, 4)
    wc = src[..., 3]
    w_safe = torch.where(wc.abs() > _EPS, wc, torch.full_like(wc, _EPS))
    sx = src[..., 0] / w_safe
    sy = src[..., 1] / w_safe
    if pos_gradient_boost != 1.0:
        sx = _BoostGrad.apply(sx, pos_gradient_boost)
        sy = _BoostGrad.apply(sy, pos_gradient_boost)

    xs = ndc(torch.arange(w, device=dev), w)
    ys = ndc(torch.arange(h, device=dev), h)

    facing = None
    if edge_adj is not None:
        edge_adj = tensor(edge_adj, dev, torch.int64)
        v = sx.detach().reshape(b, -1, 3)
        u = sy.detach().reshape(b, -1, 3)
        area2 = (v[..., 1] - v[..., 0]) * (u[..., 2] - u[..., 0]) - (
            v[..., 2] - v[..., 0]) * (u[..., 1] - u[..., 0])
        facing = area2 > 0.0  # (B, T)

    sxy = torch.stack([sx, sy], dim=-1)  # (B, 3T, 2): one gather for both

    def pairs(sl_a, sl_b, along, along_next, across, horizontal):
        return _aa_pairs(
            color[sl_a], color[sl_b], ids[sl_a], ids[sl_b], zw[sl_a], zw[sl_b],
            along, along_next, across, sxy, horizontal, edge_adj, facing)

    full = slice(None)
    # horizontal pairs (i, j) | (i, j+1): the segment along X at Y = ys[i]
    d_l, d_r = pairs((full, full, slice(None, -1)), (full, full, slice(1, None)),
                     xs[None, None, :-1], xs[None, None, 1:], ys[None, :, None], True)
    delta = torch.nn.functional.pad(d_l, (0, 0, 0, 1)) + torch.nn.functional.pad(
        d_r, (0, 0, 1, 0))
    # vertical pairs (i, j) | (i+1, j): the segment along Y at X = xs[j]
    d_t, d_b = pairs((full, slice(None, -1)), (full, slice(1, None)),
                     ys[None, :-1, None], ys[None, 1:, None], xs[None, None, :], False)
    delta = delta + torch.nn.functional.pad(d_t, (0, 0, 0, 0, 0, 1))
    delta = delta + torch.nn.functional.pad(d_b, (0, 0, 0, 0, 1, 0))
    return color + delta


def _aa_pairs(c_a, c_b, id_a, id_b, zw_a, zw_b, along, along_next, across,
              sxy, horizontal: bool, edge_adj=None, facing=None):
    """Blend deltas (delta_a, delta_b) of one pass of adjacent pixel pairs
    (``antialias.py:151-245``): a is the pixel at ``along``, b the one at
    ``along_next``; ``across`` is the segment's shared coordinate; ``sxy``
    (B, 3T, 2) the corners' screen x and y."""
    differ = id_a != id_b
    fg_is_a = (id_a > 0) & ((id_b == 0) | (zw_a <= zw_b))
    fg_id = torch.where(fg_is_a, id_a, id_b)
    active = differ & (fg_id > 0)

    tri_idx = (fg_id - 1).clamp(min=0)
    bsz = sxy.shape[0]
    flat = (tri_idx[..., None] * 3 + torch.arange(3, device=sxy.device)).reshape(bsz, -1)
    shape3 = tuple(tri_idx.shape) + (3,)
    # an inactive pair reads triangle 0's corners and blends nothing, so its
    # corners take no part in the gradient's sums
    v = IndexRows.apply(sxy, flat, active[..., None].expand(shape3).reshape(bsz, -1))
    vx = v[..., 0].reshape(shape3)
    vy = v[..., 1].reshape(shape3)
    e_along, e_across = (vx, vy) if horizontal else (vy, vx)

    silhouette = None
    if edge_adj is not None and facing is not None:
        flat_t = tri_idx.reshape(bsz, -1)
        fg_facing = facing.gather(1, flat_t).reshape(tri_idx.shape)
        nb_all = edge_adj[tri_idx]  # (..., 3) neighbour per edge
        nb_facing = facing.gather(1, nb_all.clamp(min=0).reshape(bsz, -1)).reshape(
            nb_all.shape)
        silhouette = (nb_all < 0) | (nb_facing != fg_facing[..., None])

    seg = along_next - along  # 2/W or 2/H
    lams, valids = [], []
    for k in range(3):
        k2 = (k + 1) % 3
        a0, a1 = e_across[..., k], e_across[..., k2]
        l0, l1 = e_along[..., k], e_along[..., k2]
        denom = a1 - a0
        denom_ok = denom.abs() > _EPS
        denom_safe = torch.where(denom_ok, denom, torch.full_like(denom, _EPS))
        t = (across - a0) / denom_safe
        cross_pos = l0 + t * (l1 - l0)
        lam = (cross_pos - along) / seg
        valid = (active & denom_ok & (t >= 0.0) & (t <= 1.0)
                 & (lam >= 0.0) & (lam <= 1.0))
        if silhouette is not None:
            valid = valid & silhouette[..., k]
        lams.append(lam)
        valids.append(valid)

    lam3 = torch.stack(lams, dim=-1)
    valid3 = torch.stack(valids, dim=-1)
    any_valid = valid3.any(dim=-1)
    inf = torch.full_like(lam3, float("inf"))
    lam_min = torch.where(valid3, lam3, inf).amin(dim=-1)
    lam_max = torch.where(valid3, lam3, -inf).amax(dim=-1)
    lam_sel = torch.where(fg_is_a, lam_min, lam_max)
    lam_sel = torch.where(any_valid, lam_sel, torch.full_like(lam_sel, 0.5))
    # jnp.clip(x, 0, 1) = minimum(maximum(x, 0), 1), ties split 0.5/0.5
    lam_sel = torch.minimum(torch.maximum(lam_sel, lam_sel.new_zeros(())),
                            lam_sel.new_ones(()))

    mu = torch.where(fg_is_a, lam_sel - 0.5, 0.5 - lam_sel)[..., None]
    gate = (active & any_valid)[..., None]
    fg_a = fg_is_a[..., None]
    c_fg = torch.where(fg_a, c_a, c_b)
    c_bg = torch.where(fg_a, c_b, c_a)
    diff = c_fg - c_bg
    zero = torch.zeros_like(mu)
    delta_bg = torch.where(gate, torch.maximum(mu, zero) * diff, torch.zeros_like(diff))
    delta_fg = torch.where(gate, -torch.maximum(-mu, zero) * diff, torch.zeros_like(diff))
    return torch.where(fg_a, delta_fg, delta_bg), torch.where(fg_a, delta_bg, delta_fg)
