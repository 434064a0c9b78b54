"""Packed-row shading and gather-free antialiasing (plain torch).

Counterpart of ``diffdope_tpu/render/shade.py`` (``shade_from_rows`` :141,
``antialias_rows`` / ``_aa_pairs_rows`` :211-387; the row packing of
``render_batch``'s reference branch, ``attribute_planes`` to
``shade_rows`` :47-138) and of ``pixel_ndc`` (``setup_tris.py:147``).
These are the plain, differentiable versions that the fused-loss kernels
(render/fused_loss.py, csrc/fused_loss.cu) are held to, so every
expression keeps the reference's f32 operation order.

The 32-lane row layout of one triangle (``shade.py:7-18``):

    lane  0:9   c0, c1, c2   barycentric coefficient vectors over (X, Y, 1)
    lane  9:12  zc           z/w numerator plane (over det)
    lane 12     det
    lane 13     triangle index (float; exact for T < 2**24)
    lane 14     silhouette bitmask (bit m: the line chat_m = 0 is a
                silhouette edge)
    lane 15     reserved
    lane 16:28  attribute planes g_c, value_c = g_c . (X, Y, 1) / s
    lane 28:32  conservative NDC x/y bounds (raster work gating only; 0 in
                :func:`pack_rows`'s rows, which no kernel reads)

Images are channel-planar: rows (B, 32, H, W), ids (B, H, W).

Tie rules follow JAX, which the reference differentiates with:
``torch.maximum``/``torch.minimum`` split the gradient 0.5/0.5 at
equality as ``jnp.maximum``/``jnp.clip`` do (``torch.clamp`` would not).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

PACKED_WIDTH = 32
_EPS = 1e-12


def pixel_ndc(
    resolution: Tuple[int, int],
    roi: Optional[Tuple[int, int, int, int]] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC of pixel centres: x (1, W) and y (H, 1), float32.

    ``x = (2*(col+ox)+1)/fw - 1`` with an IEEE divide
    (``fused_loss.py:137-140``).  ``roi=(oy, ox, fh, fw)`` places the
    (H, W) window at (oy, ox) of an (fh, fw) frame; the default is the
    window itself.
    """
    h, w = resolution
    oy, ox, fh, fw = roi if roi is not None else (0, 0, h, w)
    x = ndc(torch.arange(w, device=device) + ox, fw)
    y = ndc(torch.arange(h, device=device) + oy, fh)
    return x[None, :], y[:, None]


def ndc(pix: torch.Tensor, frame: int, dtype=torch.float32) -> torch.Tensor:
    """(2*pix + 1)/frame - 1 in ``dtype`` with an IEEE divide.  The divisor
    is a tensor on purpose: torch divides a CUDA tensor by a Python scalar
    as a multiply by its reciprocal, which is not the reference's rounding."""
    v = 2.0 * pix.to(dtype) + 1.0
    return v / torch.full_like(v, float(frame)) - 1.0


def attribute_planes(corner_vals: torch.Tensor, setup) -> torch.Tensor:
    """Per-triangle interpolation planes of per-corner attribute values
    (``shade.py:47-60``): (B, T, C, 3) vectors g_c with value = g_c . (X,
    Y, 1) / s.  ``corner_vals`` is (T, 3, C) or (B, T, 3, C), ``setup`` a
    ``setup_tris.TriangleSetup``; the sum over the corners runs in a fixed
    order (true float32, the reference's ``precision="highest"``)."""
    c = [setup.c0, setup.c1, setup.c2]  # (B, T, 3) each
    vals = [corner_vals[..., k, :, None] for k in range(3)]  # (.., T, C, 1)
    return (vals[0] * c[0][..., None, :] + vals[1] * c[1][..., None, :]) \
        + vals[2] * c[2][..., None, :]


def silhouette_bits(det: torch.Tensor, edge_adj: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T) float bitmask: bit m set iff the line chat_m = 0 borders a
    silhouette, a boundary edge or a front/back facing transition
    (``shade.py:63-82``).  Edge slot k joins corners (k, k+1) and lies on
    line m = (k + 2) % 3; facing is sign(det)."""
    if edge_adj is None:
        return torch.full_like(det, 7.0)  # every edge blends
    facing = det.detach() > 0.0
    bits = torch.zeros(det.shape, dtype=torch.int32, device=det.device)
    for k in range(3):
        nb = edge_adj[:, k]
        sil = (nb < 0)[None, :] | (facing[:, nb.clamp(min=0)] != facing)
        bits = bits | (sil.to(torch.int32) << ((k + 2) % 3))
    return bits.to(det.dtype)


def pack_rows(setup, sil_bits: torch.Tensor,
              planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, 32) packed rows from a setup, the silhouette bits and the
    (B, T, C, 3) attribute planes, C <= 5 (``shade.py:85-108``): lane 13
    the triangle index, 14 the bits, 16 on the planes, the rest 0."""
    coef = setup.coef
    b, t, _ = coef.shape
    tri_idx = torch.arange(t, dtype=coef.dtype, device=coef.device).expand(b, t)
    base = torch.cat([coef[..., :13], tri_idx[..., None], sil_bits[..., None],
                      coef[..., 15:16]], dim=-1)
    if planes is None:
        return torch.cat([base, coef.new_zeros((b, t, PACKED_WIDTH - 16))], dim=-1)
    flat = planes.reshape(b, t, -1)
    pad = PACKED_WIDTH - 16 - flat.shape[-1]
    if pad < 0:
        raise ValueError("too many attribute planes for the 32-lane row")
    return torch.cat([base, torch.nn.functional.pad(flat, (0, pad))], dim=-1)


def shade_rows(
    ids: torch.Tensor,
    packed: torch.Tensor,
    resolution: Tuple[int, int],
    attr_channels: int = 0,
    stack_outputs: bool = False,
) -> Dict[str, object]:
    """One row gather by triangle id, then :func:`shade_from_rows`
    (``shade.py:111-138``): ids (B, H, W) (+1, 0 = background), packed
    (B, T, 32), differentiable; the gather's backward sums each triangle's
    pixels in ascending pixel order (``rasterize.IndexRows``).  The dict
    also holds 'rows', the gathered rows channel-planar (B, 32, H, W), zero
    on background."""
    from diffdope_tpu_torch.render.rasterize import gather_rows

    b = ids.shape[0]
    fg = (ids > 0).reshape(b, -1)
    rows = gather_rows(packed, (ids.long() - 1).clamp(min=0).reshape(b, -1), fg)
    rows = torch.where(fg[..., None], rows, torch.zeros_like(rows))
    rows = rows.permute(0, 2, 1).reshape((b, PACKED_WIDTH) + tuple(ids.shape[1:]))
    out = shade_from_rows(ids, rows, resolution, attr_channels,
                          stack_outputs=stack_outputs)
    out["rows"] = rows
    return out


def shade_from_rows(
    ids: torch.Tensor,
    rows: torch.Tensor,
    resolution: Tuple[int, int],
    attr_channels: int = 0,
    xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    stack_outputs: bool = False,
) -> Dict[str, object]:
    """Shading math on gathered rows (``shade.py:141-204``).

    Returns {'zw', 's', 'attrs_list'}: each (B, H, W); attributes and zw
    are 0 on background.  ``stack_outputs`` adds 'rast' (B, H, W, 4), the
    nvdiffrast-style (u, v, z/w, id), zero on background.
    """
    x, y = pixel_ndc(resolution, device=rows.device) if xy is None else xy
    fgf = ids > 0
    e0 = rows[:, 0] * x + rows[:, 1] * y + rows[:, 2]
    e1 = rows[:, 3] * x + rows[:, 4] * y + rows[:, 5]
    e2 = rows[:, 6] * x + rows[:, 7] * y + rows[:, 8]
    zlin = rows[:, 9] * x + rows[:, 10] * y + rows[:, 11]
    det = rows[:, 12]
    s = e0 + e1 + e2
    s_safe = torch.where(s.abs() > _EPS, s, torch.ones_like(s))
    det_safe = torch.where(det != 0.0, det, torch.ones_like(det))
    zw = zlin / det_safe
    zero = torch.zeros_like(s)
    vals = []
    for c in range(attr_channels):
        g0 = rows[:, 16 + 3 * c]
        g1 = rows[:, 17 + 3 * c]
        g2 = rows[:, 18 + 3 * c]
        vals.append(torch.where(fgf, (g0 * x + g1 * y + g2) / s_safe, zero))
    out = {
        "zw": torch.where(fgf, zw, zero),
        "s": s_safe,
        "attrs_list": vals,
    }
    if stack_outputs:
        rast = torch.stack([e1 / s_safe, e2 / s_safe, zw, ids.to(rows.dtype)], dim=-1)
        out["rast"] = torch.where(fgf[..., None], rast, torch.zeros_like(rast))
    return out


def antialias_rows(
    color: torch.Tensor,
    ids: torch.Tensor,
    zw: torch.Tensor,
    rows: torch.Tensor,
    resolution: Tuple[int, int],
    xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Silhouette-edge antialiasing from the per-pixel rows
    (``shade.py:211-293``).  ``color`` is (B, H, W); ``valid`` optionally
    marks real pixels (a pair is active only when both are valid)."""
    h, w = resolution
    x, y = pixel_ndc(resolution, device=rows.device) if xy is None else xy
    x = x.expand(h, w)
    y = y.expand(h, w)
    ids_ng = ids.detach()
    zw_ng = zw.detach()
    valid_f = None
    if valid is not None:
        valid_f = valid.to(color.dtype).expand(ids_ng.shape)

    def pad(a, dim, front):
        shape = list(a.shape)
        shape[dim] = 1
        z = a.new_zeros(shape)
        return torch.cat((z, a) if front else (a, z), dim=dim)

    d_a, d_b = _aa_pairs_rows(
        color[:, :, :-1], color[:, :, 1:],
        ids_ng[:, :, :-1], ids_ng[:, :, 1:],
        zw_ng[:, :, :-1], zw_ng[:, :, 1:],
        rows[..., :-1], rows[..., 1:],
        along=x[:, :-1][None], along_next=x[:, 1:][None],
        across=y[:, :-1][None], horizontal=True,
        pair_valid=None if valid_f is None
        else valid_f[:, :, :-1] * valid_f[:, :, 1:],
    )
    delta = pad(d_a, 2, False) + pad(d_b, 2, True)
    d_t, d_bt = _aa_pairs_rows(
        color[:, :-1, :], color[:, 1:, :],
        ids_ng[:, :-1, :], ids_ng[:, 1:, :],
        zw_ng[:, :-1, :], zw_ng[:, 1:, :],
        rows[:, :, :-1, :], rows[:, :, 1:, :],
        along=y[:-1, :][None], along_next=y[1:, :][None],
        across=x[:-1, :][None], horizontal=False,
        pair_valid=None if valid_f is None
        else valid_f[:, :-1, :] * valid_f[:, 1:, :],
    )
    delta = delta + pad(d_t, 1, False) + pad(d_bt, 1, True)
    return color + delta


def _aa_pairs_rows(
    c_a, c_b, id_a, id_b, zw_a, zw_b, rows_a, rows_b,
    along, along_next, across, horizontal: bool, pair_valid=None,
):
    """Deltas of one pair direction (``shade.py:296-387``)."""
    differ = id_a != id_b
    fg_is_a = (id_a > 0) & ((id_b == 0) | (zw_a <= zw_b))
    active = differ & ((fg_is_a & (id_a > 0)) | (~fg_is_a & (id_b > 0)))
    if pair_valid is not None:
        active = active & (pair_valid > 0.5)

    def lane(k):
        return torch.where(fg_is_a, rows_a[:, k], rows_b[:, k])

    sil = lane(14).detach().to(torch.int32)
    seg = along_next - along
    any_valid = None
    lam_min = torch.full(active.shape, float("inf"), dtype=rows_a.dtype,
                         device=rows_a.device)
    lam_max = torch.full(active.shape, float("-inf"), dtype=rows_a.dtype,
                         device=rows_a.device)
    det_sign = torch.sign(lane(12)).detach()
    for m in range(3):
        am = lane(3 * m)
        bm = lane(3 * m + 1)
        cm = lane(3 * m + 2)
        if horizontal:
            denom = am
            num = -(bm * across + cm)
        else:
            denom = bm
            num = -(am * across + cm)
        denom_ok = denom.abs() > _EPS
        denom_safe = torch.where(denom_ok, denom, torch.full_like(denom, _EPS))
        cross_pos = num / denom_safe
        lam = (cross_pos - along) / seg
        on_edge = None
        for j in range(3):
            if j == m:
                continue
            aj = lane(3 * j)
            bj = lane(3 * j + 1)
            cj = lane(3 * j + 2)
            if horizontal:
                ej = aj * cross_pos + bj * across + cj
            else:
                ej = aj * across + bj * cross_pos + cj
            cond = (ej * det_sign).detach() >= 0.0
            on_edge = cond if on_edge is None else (on_edge & cond)
        valid = (
            active & denom_ok & on_edge
            & (lam >= 0.0) & (lam <= 1.0)
            & (((sil >> m) & 1) != 0)
        )
        any_valid = valid if any_valid is None else (any_valid | valid)
        lam_min = torch.where(valid & (lam < lam_min), lam, lam_min)
        lam_max = torch.where(valid & (lam > lam_max), lam, lam_max)

    lam_sel = torch.where(fg_is_a, lam_min, lam_max)
    lam_sel = torch.where(any_valid, lam_sel, torch.full_like(lam_sel, 0.5))
    # jnp.clip(x, 0, 1) = minimum(1, maximum(0, x)), ties split 0.5/0.5
    lam_sel = torch.minimum(
        torch.maximum(lam_sel, lam_sel.new_zeros(())), lam_sel.new_ones(())
    )
    mu = torch.where(fg_is_a, lam_sel - 0.5, 0.5 - lam_sel)
    gate = active & any_valid
    c_fg = torch.where(fg_is_a, c_a, c_b)
    c_bg = torch.where(fg_is_a, c_b, c_a)
    diff = c_fg - c_bg
    zero = torch.zeros_like(mu)
    delta_bg = torch.where(gate, torch.maximum(mu, zero) * diff, zero)
    delta_fg = torch.where(gate, -torch.maximum(-mu, zero) * diff, zero)
    delta_a = torch.where(fg_is_a, delta_fg, delta_bg)
    delta_b = torch.where(fg_is_a, delta_bg, delta_fg)
    return delta_a, delta_b
