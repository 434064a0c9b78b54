"""Texture sampling (the nvdiffrast ``texture`` contract), plain torch.

Counterpart of ``diffdope_tpu/render/texture.py``: ``texture`` with its
four filter modes ('nearest', 'linear', 'linear-mipmap-nearest',
'linear-mipmap-linear') and three boundary modes ('wrap', 'clamp',
'zero'), ``build_mip_pyramid`` and ``_mip_lod`` (:37-277); the planar
samplers of the semi-fused exact-texture loss, ``texture_planar``,
``pack_bilinear_blocks(4)``, ``texture_planar_packed`` and
``texture_planar_packed4`` (:119-162, 280-459).

Every expression keeps the reference's f32 operation order, so the same
inputs give the same samples.  The texel gathers are
``rasterize.IndexRows`` (the transposes of the reference's take /
take_along_axis), whose backward sums each texel's taps in a fixed order,
so a texture's gradient repeats bit for bit on the card: per tap, in
ascending pixel order; a texture shared by the B hypotheses sums every
hypothesis's taps in ascending flat order, hypothesis by hypothesis; the
'zero' mode's outside taps are left out; autograd adds the four taps'
sums.  :class:`TexturePlanarPacked4`'s backward is the reference's
regather-free VJP.  No TPU kernel here: the texel gathers run as torch
ops on the card as they ran as XLA ops on the TPU (ROADMAP queue 2 §C),
their backward the segmented sum.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffdope_tpu_torch.render.rasterize import gather_rows

FILTER_MODES = (
    "nearest", "linear", "linear-mipmap-nearest", "linear-mipmap-linear",
)


def _wrap_index(i: torch.Tensor, n, mode: str) -> torch.Tensor:
    """Texel index ``i`` under the boundary mode; ``n`` an int or a tensor
    of per-pixel sizes.  'zero' clamps here and the caller masks."""
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode in ("clamp", "zero"):
        if isinstance(n, int):
            return torch.clamp(i, 0, n - 1)
        return torch.minimum(torch.clamp(i, min=0), n - 1)
    raise ValueError(f"unknown boundary_mode {mode!r}")


def build_mip_pyramid(tex: torch.Tensor, max_level: Optional[int] = None) -> List[torch.Tensor]:
    """2x box-filtered pyramid [level0, level1, ...] of a (TH, TW, C) or
    (B, TH, TW, C) texture; stops at 1x1, ``max_level``, or the first level
    whose dimensions are odd."""
    if tex.dim() == 3:
        tex = tex[None]
    tb, th, tw, c = tex.shape
    levels = [tex]
    while (th > 1 and tw > 1 and th % 2 == 0 and tw % 2 == 0
           and (max_level is None or len(levels) <= max_level)):
        levels.append(levels[-1].reshape(tb, th // 2, 2, tw // 2, 2, c).mean(dim=(2, 4)))
        th //= 2
        tw //= 2
    return levels


def _mip_lod(uv_da: torch.Tensor, th: int, tw: int, n_levels: int) -> torch.Tensor:
    """Per-pixel level of detail from the screen-space uv derivatives
    (B, H, W, 4) = (du/dx, dv/dx, du/dy, dv/dy)."""
    dx2 = (uv_da[..., 0] * tw) ** 2 + (uv_da[..., 1] * th) ** 2
    dy2 = (uv_da[..., 2] * tw) ** 2 + (uv_da[..., 3] * th) ** 2
    foot = torch.clamp(torch.maximum(dx2, dy2), min=1e-20)
    return torch.clamp(0.5 * torch.log2(foot), 0.0, float(n_levels - 1))


def _bilinear_any_level(flat, offsets, ths, tws, level, uv, boundary_mode: str):
    """Bilinear sample at a per-pixel pyramid level: ``flat`` (B or 1, sum
    of the levels' texels, C), ``offsets``/``ths``/``tws`` per-level int
    tables indexed by ``level`` (B, H, W)."""
    th_l, tw_l, off = ths[level], tws[level], offsets[level]
    fx = uv[..., 0] * tw_l.to(uv.dtype) - 0.5
    fy = uv[..., 1] * th_l.to(uv.dtype) - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    ax = (fx - x0.to(fx.dtype))[..., None]
    ay = (fy - y0.to(fy.dtype))[..., None]
    b, c = uv.shape[0], flat.shape[-1]

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < tw_l) & (iy >= 0) & (iy < th_l)
        lin = (off + _wrap_index(iy, th_l, boundary_mode) * tw_l
               + _wrap_index(ix, tw_l, boundary_mode)).reshape(b, -1)
        if boundary_mode != "zero":
            return gather_rows(flat, lin).reshape(ix.shape + (c,))
        val = gather_rows(flat, lin, inside.reshape(b, -1)).reshape(ix.shape + (c,))
        return torch.where(inside[..., None], val, torch.zeros_like(val))

    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = c00 * (1.0 - ax) + c10 * ax
    bot = c01 * (1.0 - ax) + c11 * ax
    return top * (1.0 - ay) + bot * ay


def _gather_texels(tex: torch.Tensor, ix, iy, boundary_mode: str,
                   valid=None) -> torch.Tensor:
    """tex[b, iy, ix, :] of a (B|1, TH, TW, C) texture under the boundary
    mode (the caller masks 'zero', whose taps outside ``valid`` take no
    part in the gradient's sums)."""
    tb, th, tw, c = tex.shape
    b = ix.shape[0]
    lin = (_wrap_index(iy, th, boundary_mode) * tw
           + _wrap_index(ix, tw, boundary_mode)).reshape(b, -1)
    return gather_rows(tex.reshape(tb, th * tw, c), lin,
                       None if valid is None else valid.reshape(b, -1)).reshape(ix.shape + (c,))


def texture(tex: torch.Tensor, uv: torch.Tensor, uv_da: Optional[torch.Tensor] = None,
            filter_mode: str = "linear", boundary_mode: str = "wrap",
            mip: Optional[Sequence[torch.Tensor]] = None,
            max_mip_level: Optional[int] = None) -> torch.Tensor:
    """Sample a (TH, TW, C) or (B, TH, TW, C) texture at per-pixel ``uv``
    (B, H, W, 2) in [0, 1] (u right, v down the texture rows, as the
    V-flip at mesh load leaves it); returns (B, H, W, C).

    ``uv_da`` (B, H, W, 4), the screen-space uv derivatives of
    ``interpolate(..., diff_attrs=...)``, is required by the mipmapped
    modes and unused by 'nearest' / 'linear'.  ``mip`` is a precomputed
    :func:`build_mip_pyramid`.  Differentiable in ``tex`` (through the
    pyramid too) and ``uv``; the level selection is not differentiated."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if tex.dim() == 3:
        tex = tex[None]
    b = uv.shape[0]
    tb, th, tw, c = tex.shape

    if filter_mode in ("linear-mipmap-nearest", "linear-mipmap-linear"):
        if uv_da is None:
            raise ValueError(f"filter_mode {filter_mode!r} requires uv_da")
        levels = list(mip) if mip is not None else build_mip_pyramid(tex, max_mip_level)
        levels = [lv if lv.dim() == 4 else lv[None] for lv in levels]
        n = len(levels)
        dev = uv.device
        ths = torch.tensor([lv.shape[1] for lv in levels], dtype=torch.long, device=dev)
        tws = torch.tensor([lv.shape[2] for lv in levels], dtype=torch.long, device=dev)
        sizes = [lv.shape[1] * lv.shape[2] for lv in levels]
        offsets = torch.tensor([sum(sizes[:i]) for i in range(n)], dtype=torch.long,
                               device=dev)
        flat = torch.cat([lv.reshape(tb, -1, c) for lv in levels], dim=1)
        lod = _mip_lod(uv_da.detach(), th, tw, n)
        if filter_mode == "linear-mipmap-nearest":
            return _bilinear_any_level(flat, offsets, ths, tws, torch.round(lod).long(), uv,
                                       boundary_mode)
        l0 = torch.floor(lod).long()
        l1 = torch.clamp(l0 + 1, max=n - 1)
        frac = (lod - l0.to(lod.dtype))[..., None]
        v0 = _bilinear_any_level(flat, offsets, ths, tws, l0, uv, boundary_mode)
        v1 = _bilinear_any_level(flat, offsets, ths, tws, l1, uv, boundary_mode)
        return v0 * (1.0 - frac) + v1 * frac

    # texel-space coordinates; texel centres at integer + 0.5
    fx = uv[..., 0] * tw - 0.5
    fy = uv[..., 1] * th - 0.5

    def tap(ix, iy):
        if boundary_mode != "zero":
            return _gather_texels(tex, ix, iy, boundary_mode)
        inside = (ix >= 0) & (ix < tw) & (iy >= 0) & (iy < th)
        val = _gather_texels(tex, ix, iy, boundary_mode, inside)
        return torch.where(inside[..., None], val, torch.zeros_like(val))

    if filter_mode == "nearest":
        return tap(torch.floor(fx + 0.5).long(), torch.floor(fy + 0.5).long())
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    ax = (fx - x0.to(fx.dtype))[..., None]
    ay = (fy - y0.to(fy.dtype))[..., None]
    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = c00 * (1.0 - ax) + c10 * ax
    bot = c01 * (1.0 - ax) + c11 * ax
    return top * (1.0 - ay) + bot * ay


def _corners(u, v, th: int, tw: int):
    """(x0, y0, ax, ay) of the bilinear footprint of planar u/v."""
    fx = u * tw - 0.5
    fy = v * th - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    return x0, y0, fx - x0.to(fx.dtype), fy - y0.to(fy.dtype)


def texture_planar(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   boundary_mode: str = "wrap") -> Tuple[torch.Tensor, ...]:
    """Bilinear sampling of a (TH, TW, C) texture at planar u/v (B, H, W):
    ``texture(filter_mode='linear')``'s math with a tuple of C (B, H, W)
    planes out, the sampler of the semi-fused exact-texture loss.
    Differentiable in u/v and tex."""
    th, tw, c = tex.shape
    x0, y0, ax, ay = _corners(u, v, th, tw)
    flat = tex.reshape(1, th * tw, c)

    def tap(ix, iy):
        lin = (_wrap_index(iy, th, boundary_mode) * tw
               + _wrap_index(ix, tw, boundary_mode)).reshape(1, -1)
        if boundary_mode != "zero":
            texels = gather_rows(flat, lin)[0]
        else:
            inside = ((ix >= 0) & (ix < tw) & (iy >= 0) & (iy < th)).reshape(1, -1)
            texels = gather_rows(flat, lin, inside)[0]
            texels = torch.where(inside[0, :, None], texels, torch.zeros_like(texels))
        return [texels[:, ch].reshape(ix.shape) for ch in range(c)]

    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    out = []
    for ch in range(c):
        top = c00[ch] * (1.0 - ax) + c10[ch] * ax
        bot = c01[ch] * (1.0 - ax) + c11[ch] * ax
        out.append(top * (1.0 - ay) + bot * ay)
    return tuple(out)


def pack_bilinear_blocks(tex, boundary_mode: str = "wrap") -> Optional[np.ndarray]:
    """Each channel's 2x2 bilinear footprint of an 8-bit-quantized texture
    packed into one uint32 per texel (numpy, at set-up):

        table_c[y, x] = t8[y, x] | t8[y, x+1]<<8 | t8[y+1, x]<<16 | t8[y+1, x+1]<<24

    with the neighbours wrapped at pack time.  Returns (C, TH*TW) uint32, or
    None when the texture is not 8-bit-quantized f32 (TH, TW, C) or the
    boundary is not 'wrap' (the clamp/zero tap pairs are not a function of
    one wrapped index)."""
    if boundary_mode != "wrap":
        return None
    t = tex.detach().cpu().numpy() if isinstance(tex, torch.Tensor) else np.asarray(tex)
    if t.ndim != 3 or t.dtype != np.float32:
        return None
    t255 = t * 255.0
    t8 = np.round(t255)
    if not np.allclose(t255, t8, atol=1e-4) or t8.min() < 0 or t8.max() > 255:
        return None
    t8 = t8.astype(np.uint32)
    th, tw, c = t8.shape
    x1 = (np.arange(tw) + 1) % tw
    y1 = (np.arange(th) + 1) % th
    tables = []
    for ch in range(c):
        p = t8[:, :, ch]
        tables.append((p | (p[:, x1] << 8) | (p[y1, :] << 16) | (p[y1][:, x1] << 24))
                      .reshape(-1))
    return np.stack(tables, axis=0)


def pack_bilinear_blocks4(tex, boundary_mode: str = "wrap") -> Optional[np.ndarray]:
    """:func:`pack_bilinear_blocks` as one (TH*TW, 4) row-major uint32
    table, column c channel c's block, columns past C zero: one row gather
    fetches every channel.  None whenever :func:`pack_bilinear_blocks`
    would be, or for more than 4 channels."""
    t = pack_bilinear_blocks(tex, boundary_mode)
    if t is None or t.shape[0] > 4:
        return None
    c, n = t.shape
    out = np.zeros((n, 4), np.uint32)
    out[:, :c] = t.T
    return out


def table_tensor(table: np.ndarray, device) -> torch.Tensor:
    """A packed uint32 table as the int32 tensor the samplers read (the
    same bits; the unpack masks every byte)."""
    return torch.as_tensor(np.ascontiguousarray(table).view(np.int32), device=device)


def _unpack(blk: torch.Tensor):
    """The four f32 corner texels (c00, c10, c01, c11) of packed blocks."""
    # the byte values / 255 made on the device by a true division (numpy's
    # float32 bits): no host data enters a captured step
    unit = (torch.arange(256, dtype=torch.float32, device=blk.device)
            / torch.full((), 255.0, device=blk.device))
    return tuple(unit[(blk >> s) & 255] for s in (0, 8, 16, 24))


def _wrapped_block(u, v, th: int, tw: int):
    x0, y0, ax, ay = _corners(u, v, th, tw)
    lin = (_wrap_index(y0, th, "wrap") * tw + _wrap_index(x0, tw, "wrap")).reshape(-1)
    return lin, x0.shape, ax, ay


def texture_planar_packed(tables: torch.Tensor, th: int, tw: int, u, v,
                          boundary_mode: str = "wrap") -> Tuple[torch.Tensor, ...]:
    """Bilinear sampling from :func:`pack_bilinear_blocks` tables ((C, TH*TW)
    int32, :func:`table_tensor`): one gather per channel, the same samples
    as :func:`texture_planar` on the 8-bit texture.  Differentiable in u/v
    only."""
    if boundary_mode != "wrap":
        raise ValueError("texture_planar_packed supports wrap only (see pack_bilinear_blocks)")
    lin, shape, ax, ay = _wrapped_block(u, v, th, tw)
    out = []
    for ch in range(tables.shape[0]):
        c00, c10, c01, c11 = _unpack(tables[ch][lin].reshape(shape))
        top = c00 * (1.0 - ax) + c10 * ax
        bot = c01 * (1.0 - ax) + c11 * ax
        out.append(top * (1.0 - ay) + bot * ay)
    return tuple(out)


def _packed4_fwd(table4, u, v, th: int, tw: int, nch: int):
    lin, shape, ax, ay = _wrapped_block(u, v, th, tw)
    blk4 = table4[lin]  # (N, 4)
    outs, gxs, gys = [], [], []
    for ch in range(nch):
        c00, c10, c01, c11 = _unpack(blk4[:, ch].reshape(shape))
        top = c00 * (1.0 - ax) + c10 * ax
        bot = c01 * (1.0 - ax) + c11 * ax
        outs.append(top * (1.0 - ay) + bot * ay)
        gxs.append((c10 - c00) * (1.0 - ay) + (c11 - c01) * ay)
        gys.append(bot - top)
    return torch.stack(outs), torch.stack(gxs), torch.stack(gys)


class TexturePlanarPacked4(torch.autograd.Function):
    """Bilinear sampling from a :func:`pack_bilinear_blocks4` table (the
    reference's ``texture_planar_packed4`` with its custom VJP): one wide
    row gather for every channel forward; the backward reads the saved
    d out / d ax and d out / d ay planes and never the table (d_u =
    sum_c d_out * gx * TW, d_v = sum_c d_out * gy * TH).  Differentiable in
    u/v only."""

    @staticmethod
    def forward(ctx, table4, u, v, th: int, tw: int, nch: int):
        out, gx, gy = _packed4_fwd(table4, u, v, th, tw, nch)
        ctx.save_for_backward(gx, gy)
        ctx.th, ctx.tw = th, tw
        return out

    @staticmethod
    def backward(ctx, d_out):
        gx, gy = ctx.saved_tensors
        d_u = (d_out * gx).sum(dim=0) * float(ctx.tw)
        d_v = (d_out * gy).sum(dim=0) * float(ctx.th)
        return None, d_u, d_v, None, None, None


def texture_planar_packed4(table4: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                           th: int, tw: int, nch: int) -> torch.Tensor:
    """(C, *u.shape) samples of the 8-bit texture that ``table4`` ((TH*TW,
    4) int32, :func:`table_tensor`) packs, bit for bit those of
    :func:`texture_planar`; see :class:`TexturePlanarPacked4`."""
    return TexturePlanarPacked4.apply(table4, u, v, th, tw, nch)
