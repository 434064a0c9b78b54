"""Differentiable rasterization with the nvdiffrast ``rasterize`` contract.

Counterpart of ``diffdope_tpu/render/rasterize.py``.  Clip-space positions
(B, N, 4) and triangles (T, 3) give ``rast`` (B, H, W, 4) = (u, v, z/w,
triangle id + 1; all zero on background) and ``rast_db`` (B, H, W, 4) =
(du/dx, du/dy, dv/dx, dv/dy) in pixels; an attribute is a0*(1-u-v) + a1*u +
a2*v (u weights vertex 1, v vertex 2).

Two phases, as in the reference:

- the triangle-id search, discrete and not differentiable: K8
  (:func:`raster_ids`, ``csrc/rasterize.cu``) over the screen-tile bins of
  ``setup_tris.bin_triangles``, with its plain twin
  :func:`raster_ids_binned_plain`; or the brute force over every triangle
  (:func:`raster_ids_reference`), for small meshes;
- the differentiable re-evaluation of (u, v, z/w) and their pixel
  derivatives at each pixel's triangle (:func:`rast_from_ids`, plain torch
  autograd but for the setup rows' gather, :class:`SetupRows`, whose
  backward sums each triangle's pixels in a fixed order): the gradient
  reaches ``pos_clip`` through it.  Coverage
  itself has no gradient; ``antialias`` supplies the coverage gradient.

The id search's numeric contract (``rasterize.py:123-143``): pixel NDC
x = (2*col + 1)/W - 1 with an IEEE divide, edge functions
e = (c0*x + c1*y) + c2 left to right without FMA, coverage e*sign(det) >= 0
on all three edges and det != 0, z = zlin / det an IEEE divide, -1 <= z <=
1, and a strictly nearer z wins, so on a tie the smallest triangle index
(the first in a bin, whose indices ascend) keeps the pixel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.render.raster import _check
from diffdope_tpu_torch.render.setup_tris import (
    SETUP_WIDTH,
    TriangleSetup,
    bin_triangles,
    pixel_ndc,
    triangle_setup,
    triangle_setup_from_corners,
)
from diffdope_tpu_torch.render.shade import ndc

#: lanes of a setup row the id search reads: the edge planes, zc and det
_ID_LANES = 13
#: the brute-force auto rule: meshes of at most this many triangles take
#: ``raster_ids_reference`` (``rasterize.py:323-324``)
AUTO_REFERENCE_MAX_TRIS = 256


def _edges_z(c, x, y):
    """(covered-and-in-depth-range mask, z) of setup rows ``c`` (a list of
    13 lanes) at NDC (x, y), in the reference's operation order."""
    e = [(c[3 * m] * x + c[3 * m + 1] * y) + c[3 * m + 2] for m in range(3)]
    zlin = (c[9] * x + c[10] * y) + c[11]
    det = c[12]
    sgn = torch.sign(det)
    nz = det != 0.0
    covered = (e[0] * sgn >= 0) & (e[1] * sgn >= 0) & (e[2] * sgn >= 0) & nz
    z = zlin / torch.where(nz, det, torch.ones_like(det))
    return covered & (z >= -1.0) & (z <= 1.0), z


@torch.no_grad()
def raster_ids_reference(coef: torch.Tensor, resolution: Tuple[int, int],
                         chunk: int = 64) -> torch.Tensor:
    """Brute-force triangle-id search, every triangle at every pixel
    (``rasterize.py:54-103``), ``chunk`` triangles at a time: (B, H, W)
    int32, 0 = background, t+1 = triangle t.  Its temporaries are
    (B, chunk, H, W): it is for small meshes."""
    b, t, _ = coef.shape
    h, w = resolution
    x, y = pixel_ndc(resolution, device=coef.device)
    inf = torch.full((), float("inf"), device=coef.device)
    zbest = torch.full((b, h, w), float("inf"), device=coef.device)
    ibest = torch.zeros((b, h, w), dtype=torch.int32, device=coef.device)
    for start in range(0, t, chunk):
        c = coef[:, start:start + chunk, :_ID_LANES, None, None]  # (B, C, 13, 1, 1)
        ok, z = _edges_z([c[:, :, i] for i in range(_ID_LANES)], x, y)
        z_chunk, k_chunk = torch.where(ok, z, inf).min(dim=1)  # first of equal minima
        better = z_chunk < zbest
        zbest = torch.where(better, z_chunk, zbest)
        ibest = torch.where(better, (k_chunk + start + 1).to(torch.int32), ibest)
    return ibest


def _check_ids_inputs(coef, tile_idx, tile_counts, resolution, tile_hw):
    """(nty, ntx) of the padded frame; raises on inputs K8 does not take."""
    _check(coef, "coef", torch.float32, 3, coef.device)
    _check(tile_idx, "tile_idx", torch.int32, 2, coef.device)
    _check(tile_counts, "tile_counts", torch.int32, 1, coef.device)
    if coef.shape[2] != SETUP_WIDTH:
        raise ValueError(f"coef: expected {SETUP_WIDTH} lanes, got {coef.shape[2]}")
    (h, w), (th, tw) = resolution, tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    if tile_idx.shape[0] != nty * ntx or tile_counts.shape[0] != nty * ntx:
        raise ValueError(f"{tile_idx.shape[0]} tile lists and {tile_counts.shape[0]} "
                         f"counts for {nty * ntx} tiles of {tile_hw} over {resolution}")
    return nty, ntx


def raster_ids(
    coef: torch.Tensor,
    tile_idx: torch.Tensor,
    tile_counts: torch.Tensor,
    resolution: Tuple[int, int],
    tile_hw: Tuple[int, int] = (32, 128),
) -> torch.Tensor:
    """K8: the binned triangle-id search (``raster_ids_pallas``,
    ``rasterize.py:151-216``): for every (hypothesis, tile) the z-tested
    search over the tile's first ``tile_counts[t]`` bin entries.

    Args:
        coef: (B, T, 16) float32 setup rows (no gradient is taken).
        tile_idx: (num_tiles, K) int32 triangle indices per row-major tile,
            shared across the batch (``bin_triangles``).
        tile_counts: (num_tiles,) int32 valid entries per tile.
        resolution: (H, W).  tile_hw: (th, tw), any size.

    Returns (B, H, W) int32 ids (+1, 0 = background): the padded
    (nty*th, ntx*tw) frame, sliced.  CPU tensors take
    :func:`raster_ids_binned_plain`; CUDA tensors launch the kernel; any
    other device raises."""
    coef = coef.detach().contiguous()
    nty, ntx = _check_ids_inputs(coef, tile_idx, tile_counts, resolution, tile_hw)
    if coef.device.type == "cpu":
        return raster_ids_binned_plain(coef, tile_idx, tile_counts, resolution, tile_hw)
    if coef.device.type != "cuda":
        raise ValueError(f"raster_ids: unsupported device {coef.device}")
    check_kernel_frame(coef, nty, ntx, tile_hw)
    b, t_count, _ = coef.shape
    (h, w), (th, tw) = resolution, tile_hw
    ids = torch.empty((b, nty * th, ntx * tw), dtype=torch.int32, device=coef.device)
    boxes = torch.empty((b, t_count, 2), dtype=torch.int32, device=coef.device)  # scratch
    kernels.launch(
        "dd_raster_ids", "raster_ids",
        coef.data_ptr(), tile_idx.data_ptr(), tile_counts.data_ptr(),
        b, t_count, tile_idx.shape[1], nty, ntx, th, tw, h, w, ids.data_ptr(),
        boxes.data_ptr(),
    )
    return ids[:, :h, :w]


def check_kernel_frame(rows: torch.Tensor, nty: int, ntx: int, tile_hw) -> None:
    """Raise on inputs the K8/K9 forward kernel does not take: rows that
    are not 16-byte aligned (it stages them with float4 loads) or a padded
    frame of 2^15 pixels a side or more (its boxes pack a pixel range in 16
    bits)."""
    if rows.data_ptr() % 16:
        raise ValueError("the K8/K9 forward takes 16-byte aligned rows (float4 loads)")
    th, tw = tile_hw
    if max(nty * th, ntx * tw) >= 2 ** 15:
        raise ValueError(f"the K8/K9 forward takes padded frames below {2 ** 15} pixels "
                         f"a side, not {(nty * th, ntx * tw)}")


@torch.no_grad()
def raster_ids_binned_plain(coef, tile_idx, tile_counts, resolution,
                            tile_hw=(32, 128), slot_chunk: int = 64) -> torch.Tensor:
    """Plain torch K8: every tile walks the first ``tile_counts[t]`` (at
    most K) entries of its bin, ``slot_chunk`` at a time, in ascending
    order, and a pixel keeps the first strictly nearest z; the entries
    past a tile's count are never read, as in K8."""
    nty, ntx = _check_ids_inputs(coef, tile_idx, tile_counts, resolution, tile_hw)
    b = coef.shape[0]
    (h, w), (th, tw) = resolution, tile_hw
    dev = coef.device
    nt, npx = nty * ntx, th * tw
    ti = torch.arange(nt, device=dev)
    pi = torch.arange(npx, device=dev)
    prow = (ti // ntx)[:, None] * th + (pi // tw)[None, :]  # (nt, npx)
    pcol = (ti % ntx)[:, None] * tw + (pi % tw)[None, :]
    x = ndc(pcol, w)[..., None]  # (nt, npx, 1)
    y = ndc(prow, h)[..., None]
    n = tile_counts.long().clamp(max=tile_idx.shape[1])
    smax = int(n.max()) if nt else 0
    inf = torch.tensor(float("inf"), device=dev)

    ids = torch.zeros((b, nty * th, ntx * tw), dtype=torch.int32, device=dev)
    flat_pix = (prow * (ntx * tw) + pcol).reshape(-1)
    for bi in range(b):
        zb = torch.full((nt, npx), float("inf"), device=dev)
        ib = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
        for s0 in range(0, smax, slot_chunk):
            j = torch.arange(s0, min(s0 + slot_chunk, smax), device=dev)
            in_tile = j[None, :] < n[:, None]  # (nt, ch)
            tri = tile_idx[:, s0:s0 + j.numel()].long()
            rows = coef[bi][tri.clamp(max=coef.shape[1] - 1)]  # (nt, ch, 16)
            lanes = [rows[:, None, :, i] for i in range(_ID_LANES)]  # (nt, 1, ch)
            ok, z = _edges_z(lanes, x, y)
            z_c, k_c = torch.where(ok & in_tile[:, None, :], z, inf).min(dim=-1)
            better = z_c < zb
            zb = torch.where(better, z_c, zb)
            ib = torch.where(better, (tri.gather(1, k_c) + 1).to(torch.int32), ib)
        ids.view(b, -1)[bi, flat_pix] = ib.reshape(-1)
    return ids[:, :h, :w]


def setup_rows_bwd(d_rows: torch.Tensor, ids: torch.Tensor, t_count: int,
                   counter: str = "setup_rows_bwd") -> torch.Tensor:
    """d_coef (B, T, W): each triangle's row the sum of its foreground
    pixels' row cotangents ``d_rows`` (B, P, W), in ascending pixel order
    (ids (B, P), +1, 0 = background).

    CPU tensors take :func:`setup_rows_bwd_plain`; CUDA tensors (f32) sort
    the foreground pixels stably by (hypothesis, triangle) and launch the
    segmented sum (csrc/rasterize.cu, ``dd_segment_sum``), counted under
    ``counter``; anything else raises."""
    _check(ids, "ids", torch.int32, 2, d_rows.device)
    b, p = ids.shape
    if d_rows.dim() != 3 or tuple(d_rows.shape[:2]) != (b, p):
        raise ValueError(f"d_rows {tuple(d_rows.shape)} / ids {tuple(ids.shape)}")
    if d_rows.device.type == "cpu":
        return setup_rows_bwd_plain(d_rows, ids, t_count)
    if d_rows.device.type != "cuda":
        raise ValueError(f"setup_rows_bwd: unsupported device {d_rows.device}")
    _check(d_rows, "d_rows", torch.float32, 3, d_rows.device)
    width = d_rows.shape[2]
    if b * p >= 2 ** 31 or b * t_count >= 2 ** 31:
        raise ValueError(f"{b * p} pixels / {b * t_count} rows exceed int32 indexing")
    order, start = segments(ids, t_count)
    out = torch.empty((b, t_count, width), dtype=torch.float32, device=d_rows.device)
    # one hypothesis of B*T segments over the (B*P, W) rows
    kernels.launch(
        "dd_segment_sum", counter,
        d_rows.data_ptr(), order.data_ptr(), start.data_ptr(), 1, b * t_count, width,
        0, width, 1, out.data_ptr(),
    )
    return out


def segments(ids: torch.Tensor, t_count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, start), int32: the flat indices of the foreground pixels of
    ids (B, P) sorted stably by (hypothesis, triangle), and where each of
    the B*T (hypothesis, triangle) segments starts in ``order`` (B*T + 1
    entries).  Background pixels sort past every segment, so nothing waits
    on the host.  The keys are int32 (B*T < 2**31), which halves the
    sort's key buffers."""
    b = ids.shape[0]
    nseg = b * t_count
    hyp = torch.arange(b, device=ids.device, dtype=torch.int32)[:, None] * t_count
    key = torch.where(ids > 0, hyp + ids.to(torch.int32) - 1, nseg).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        sorted_key, torch.arange(nseg + 1, device=ids.device, dtype=torch.int32),
        out_int32=True)
    return order.to(torch.int32), start


def setup_rows_bwd_plain(d_rows: torch.Tensor, ids: torch.Tensor,
                         t_count: int) -> torch.Tensor:
    """Plain torch :func:`setup_rows_bwd`: an index_add of the foreground
    pixels' cotangents into their triangles' rows (in index order on the
    CPU; with atomics, in no fixed order, on the card)."""
    b, p, width = d_rows.shape
    hyp = torch.arange(b, device=ids.device)[:, None] * t_count
    key = torch.where(ids > 0, hyp + ids.long() - 1, b * t_count).reshape(-1)
    acc = torch.zeros((b * t_count + 1, width), dtype=d_rows.dtype, device=d_rows.device)
    acc.index_add_(0, key, d_rows.reshape(-1, width))
    return acc[:-1].reshape(b, t_count, width)


def slot_segments(tile_idx: torch.Tensor, t_count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, start) of the slots of bins ``tile_idx`` (num_tiles, K)
    sorted by triangle (:func:`segments`; sentinel slots, index T, past
    every triangle): what :func:`slot_sums` reads on the card.  The
    ``DD_BINNED=0`` route sorts them in its forward, where a step holds
    less memory than in its backward (``raster.RasterV2``)."""
    flat = tile_idx.reshape(1, -1)
    return segments(torch.where(flat < t_count, flat + 1, 0), t_count)


def slot_sums(d_bins: torch.Tensor, tile_idx: torch.Tensor, t_count: int,
              segs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """d_packed (B, 32, T) of the ``DD_BINNED=0`` route: for each triangle
    the sum of its slots' cotangents in d_bins (B, 32, num_tiles*K), in
    ascending slot order, the order in which the reference's inverted bin
    map lists its occurrences (its gather-sum in XLA,
    ``raster_v2.py:1701-1708``), every occurrence at shapes the bins fix.

    CPU tensors take :func:`setup_rows_bwd_plain` (an index_add in slot
    order, the hypotheses side by side in a row); CUDA tensors take the
    slots sorted by triangle (``segs``, :func:`slot_segments` if None)
    and launch the segmented sum once for every hypothesis, reading each
    held slot's 32 lanes in d_bins where they lie, through its strides
    (counted as 'index_rows_bwd'); anything else raises."""
    b, width, n_slots = d_bins.shape
    if d_bins.device.type == "cpu":
        flat = tile_idx.reshape(1, n_slots)
        ids = torch.where(flat < t_count, flat + 1, 0).to(torch.int32)
        rows = d_bins.permute(2, 0, 1).reshape(1, n_slots, b * width)
        d = setup_rows_bwd_plain(rows, ids, t_count)
        return d.reshape(t_count, b, width).permute(1, 2, 0).contiguous()
    if d_bins.device.type != "cuda":
        raise ValueError(f"slot_sums: unsupported device {d_bins.device}")
    _check(d_bins, "d_bins", torch.float32, 3, d_bins.device)
    if n_slots >= 2 ** 31:
        raise ValueError(f"{n_slots} slots exceed int32 indexing")
    order, start = segs if segs is not None else slot_segments(tile_idx, t_count)
    out = torch.empty((b, t_count, width), dtype=torch.float32, device=d_bins.device)
    hyp_stride, lane_stride, slot_stride = d_bins.stride()
    kernels.launch(
        "dd_segment_sum", "index_rows_bwd",
        d_bins.data_ptr(), order.data_ptr(), start.data_ptr(), b, t_count, width,
        hyp_stride, slot_stride, lane_stride, out.data_ptr(),
    )
    return out.permute(0, 2, 1).contiguous()


class SetupRows(torch.autograd.Function):
    """(B, P, W) the setup row of each pixel's triangle, zeros on
    background (ids (B, P), +1, 0 = background), differentiable in the
    rows ``coef`` (B, T, W) through :func:`setup_rows_bwd`; the
    reference's take_along_axis (``rasterize.py:245``) reads triangle 0
    on background, where every output is then masked to 0."""

    @staticmethod
    def forward(ctx, coef, ids):
        b, t_count, width = coef.shape
        idx = (ids.long() - 1).clamp(min=0)
        rows = coef.gather(1, idx[..., None].expand(-1, -1, width))
        ctx.save_for_backward(ids)
        ctx.t_count = t_count
        return torch.where((ids > 0)[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, d_rows):
        (ids,) = ctx.saved_tensors
        return setup_rows_bwd(d_rows.contiguous(), ids, ctx.t_count), None


class IndexRows(torch.autograd.Function):
    """(B, P, W) the rows ``src[b, idx[b, p]]`` of src (B, N, W) at idx
    (B, P) int64, differentiable in ``src`` with a deterministic backward:
    row n of the gradient sums, in ascending entry order, the cotangents
    of the entries idx[b, p] = n where ``valid`` (B, P), by
    :func:`setup_rows_bwd` (counted under 'index_rows_bwd' on the card).
    A source of batch 1 is shared by the B hypotheses: its rows sum every
    hypothesis's entries in ascending flat order (hypothesis by hypothesis,
    each in ascending p).  An entry outside ``valid`` must carry a zero
    cotangent (its output is masked by the caller): it is left out of the
    sums.  Every gather of the port whose source takes a gradient takes
    it in place of autograd's scatter-add, which adds with atomics on the
    card, so the gradients repeat bit for bit (:func:`gather_rows`)."""

    @staticmethod
    def forward(ctx, src, idx, valid):
        flat = idx.reshape(src.shape[0], -1)
        if ctx.needs_input_grad[0]:
            ids = torch.where(valid, idx + 1, 0).to(torch.int32).reshape(flat.shape)
            ctx.save_for_backward(ids.contiguous())
            ctx.n_rows = src.shape[1]
        out = src.gather(1, flat[..., None].expand(-1, -1, src.shape[2]))
        return out.reshape(tuple(idx.shape) + (src.shape[2],))

    @staticmethod
    def backward(ctx, d_rows):
        (ids,) = ctx.saved_tensors
        d = d_rows.reshape(ids.shape + (d_rows.shape[-1],)).contiguous()
        # an entry whose cotangent is all zero adds nothing (a sum starts at
        # +0, and x + (+-0) is x): left out, a row that every masked entry
        # reads (the background's texel) sums only what reaches it
        ids = torch.where((d != 0).any(dim=-1), ids, 0)
        return setup_rows_bwd(d, ids, ctx.n_rows, "index_rows_bwd"), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:class:`IndexRows` of src (B, N, W) at idx (B, P), or at idx (P,)
    for every hypothesis; ``valid`` defaults to every entry."""
    if idx.dim() == 1:
        idx = idx.expand(src.shape[0], -1)
    if valid is None:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return IndexRows.apply(src, idx, valid)


def setup_rows(coef: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The setup rows (B, H*W, 16) of ids (B, H, W): :class:`SetupRows`."""
    return SetupRows.apply(coef, ids.reshape(ids.shape[0], -1).to(torch.int32).contiguous())


def rast_from_ids(
    ids: torch.Tensor,
    setup: TriangleSetup,
    resolution: Tuple[int, int],
    with_db: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(u, v, z/w) re-evaluated differentiably at each pixel's triangle
    (``rasterize.py:223-279``).

    Args:
        ids: (B, H, W) int32 triangle ids (+1, 0 = background), no gradient.
        setup: the setup with its gradient to ``pos_clip`` intact.
        resolution: (H, W).  with_db: also return ``rast_db``.

    Returns rast (B, H, W, 4) = (u, v, z/w, id as float) and rast_db
    (B, H, W, 4) or None; both zero on background.  The rows' gather
    (:class:`SetupRows`) has a deterministic backward: the card's gradient
    repeats bit for bit from call to call."""
    h, w = resolution
    x, y = pixel_ndc(resolution, device=ids.device)
    fg = (ids > 0)[..., None]
    rows = setup_rows(setup.coef, ids).reshape(ids.shape + (SETUP_WIDTH,))
    r = [rows[..., i] for i in range(13)]

    e0 = (r[0] * x + r[1] * y) + r[2]
    e1 = (r[3] * x + r[4] * y) + r[5]
    e2 = (r[6] * x + r[7] * y) + r[8]
    zlin = (r[9] * x + r[10] * y) + r[11]
    det = r[12]
    s = (e0 + e1) + e2
    one = torch.ones_like(s)
    s_safe = torch.where(s.abs() > 1e-30, s, one)
    det_safe = torch.where(det != 0.0, det, one)
    u = e1 / s_safe
    v = e2 / s_safe
    zw = zlin / det_safe
    rast = torch.stack([u, v, zw, ids.to(rows.dtype)], dim=-1)
    rast = torch.where(fg, rast, torch.zeros_like(rast))
    if not with_db:
        return rast, None

    # u = e1/s with e1 and s affine in NDC; dX/dpx = 2/W, dY/dpy = 2/H
    ax_s = (r[0] + r[3]) + r[6]
    ay_s = (r[1] + r[4]) + r[7]
    inv_s2 = 1.0 / (s_safe * s_safe)
    dudx = (r[3] * s - e1 * ax_s) * inv_s2 * (2.0 / w)
    dudy = (r[4] * s - e1 * ay_s) * inv_s2 * (2.0 / h)
    dvdx = (r[6] * s - e2 * ax_s) * inv_s2 * (2.0 / w)
    dvdy = (r[7] * s - e2 * ay_s) * inv_s2 * (2.0 / h)
    db = torch.stack([dudx, dudy, dvdx, dvdy], dim=-1)
    return rast, torch.where(fg, db, torch.zeros_like(db))


def rasterize(
    pos_clip: Optional[torch.Tensor],
    tri,
    resolution: Tuple[int, int],
    *,
    impl: str = "auto",
    tile_hw: Tuple[int, int] = (32, 128),
    max_tris_per_tile: int = 1024,
    with_db: bool = True,
    corners_clip: Optional[torch.Tensor] = None,
    device="cuda",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """nvdiffrast-compatible rasterization (``rasterize.py:286-345``).

    Args:
        pos_clip: (B, N, 4) float32 clip-space positions (differentiable);
            may be None when ``corners_clip`` is given.
        tri: (T, 3) triangle indices.
        resolution: (H, W).
        impl: 'pallas' (the binned search: K8 on the card, its plain twin
            for CPU tensors), 'reference' (the brute force) or 'auto'
            (the brute force for at most ``AUTO_REFERENCE_MAX_TRIS``
            triangles, else K8) -- the JAX package's names.
        tile_hw / max_tris_per_tile: the binning of the 'pallas' route; a
            tile past K triangles drops the rest silently, as in the
            reference (call ``setup_tris.bin_triangles`` to see the
            overflow).
        with_db: also return ``rast_db``.
        corners_clip: optional (B, T, 3, 4) corner-expanded clip positions
            in place of ``pos_clip``.
        device: where numpy inputs go; tensors stay on their own device.

    Returns (rast, rast_db), each (B, H, W, 4); rast_db None without
    ``with_db``.
    """
    src = corners_clip if corners_clip is not None else pos_clip
    dev = src.device if isinstance(src, torch.Tensor) else torch.device(device)
    tri = tensor(tri, dev, torch.int64)
    if corners_clip is not None:
        corners_clip = tensor(corners_clip, dev)
        setup = triangle_setup_from_corners(corners_clip)
    else:
        pos_clip = tensor(pos_clip, dev)
        setup = triangle_setup(pos_clip, tri)
    if impl == "auto":
        impl = "reference" if tri.shape[0] <= AUTO_REFERENCE_MAX_TRIS else "pallas"
    if impl == "reference":
        ids = raster_ids_reference(setup.coef, resolution)
    elif impl == "pallas":
        corners = (corners_clip if corners_clip is not None else pos_clip[:, tri]).detach()
        idx, counts, _overflow = bin_triangles(
            corners, setup.det.detach(), resolution, tile_hw, max_tris_per_tile
        )
        ids = raster_ids(setup.coef, idx, counts, resolution, tile_hw)
    else:
        raise ValueError(f"unknown rasterize impl {impl!r} (pallas | reference | auto)")
    return rast_from_ids(ids, setup, resolution, with_db=with_db)
