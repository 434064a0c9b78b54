"""Bin-ordered pack forward (K1) and pose backward (K2).

Counterpart of ``diffdope_tpu/render/pack_kernel.py``: ``_static_table``
and ``_mvpm`` (:318-349), ``pack_binned_pallas`` (:415-448, kernels
``_fwd_pack_kernel`` :65 and ``_bwd_pack_kernel`` :165) and the
eligibility rules of ``pack_binned_auto`` (:451-490).  The kernels are in
``csrc/pack.cu``; their plain version is ``planar.pack_binned`` and its
autograd, which CPU tensors take, and which inputs the rules refuse (traced
vertices or colours) take on every device, as the reference's XLA pack.

K1 builds the (B, 32, n) table from the (B, 20) per-hypothesis scalars
(mvp rows, then row 2 of the pose) and the static per-slot table; K2
reduces the table's cotangent straight to d_mvp and row 2 of d_mtx.  The
pack is differentiable in mvp and mtx only: the static table (vertices,
attributes) and the silhouette bits are constants.

The compact and the uniform-K table of one set of bins hold the same
slots per tile in the same order and differ only in their sentinel
padding, so neither K2 nor its plain version :func:`pack_bwd_plain` sums
the uniform table by position.  K2 sums at the compact layout's places:
the compact table's own positions, the uniform table's slots moved there
(:func:`slot_order`, built once a table).  The plain version sums the
live slots alone, gathered in table order.  So each gives the two tables
the same pose gradient bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.planar import compact_bins, pack_binned, packed_planar
from diffdope_tpu_torch.render.raster import _check
from diffdope_tpu_torch.render.shade import PACKED_WIDTH

#: K2's output per hypothesis: d_mvp (16, row-major), d_mtx row 2 (3)
N_OUT = 19
#: places per K2 block (csrc/pack.cu kChunk): the partial-sum scratch size
_CHUNK = 2048
#: attribute channels the 32-lane layout holds beside the 3 rotated-z lanes
MAX_CHANNELS = 3


def _static_table(flat: torch.Tensor, t_count: int,
                  static_table: Tuple[torch.Tensor, int]) -> Tuple[torch.Tensor, int]:
    """K1's static row table for the slots of ``flat``: (9 + 3*n_ch + 2, n)
    — the mesh's static rows (``planar.static_pack_rows``) gathered per
    slot, then the slot's unclamped triangle id, then its degenerate flag
    (mesh padding or a sentinel slot)."""
    table, n_ch = static_table
    safe = flat.clamp(max=t_count - 1)
    tab = table[:, safe]
    degen = flat >= t_count
    if table.shape[0] > 9 + 3 * n_ch:  # the degenerate-triangle row
        degen = degen | (tab[9 + 3 * n_ch] > 0.5)
        tab = tab[: 9 + 3 * n_ch]
    return torch.cat([tab, flat.to(tab.dtype)[None], degen.to(tab.dtype)[None]]), n_ch


def _mvpm(mvp: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """(B, 20) float32: mvp row-major (16), row 2 of mtx (3), a pad."""
    b = mvp.shape[0]
    return torch.cat(
        [mvp.reshape(b, 16), mtx[:, 2, :3], mvp.new_zeros((b, 1))], dim=1
    ).to(torch.float32).contiguous()


def slot_order(flat: torch.Tensor, counts: torch.Tensor, t_count: int, k_chunk: int,
               degenerate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's places for the uniform-K table ``flat`` (n,) of bins with
    ``counts`` (nt,) slots a tile (tile t's slots at positions t*K + r,
    r < counts[t], K = n / nt): (n + 1,) int32, the table position summed
    at each place, -1 for none (a tile's padding, a sentinel, a slot of a
    ``degenerate`` (T,) triangle, whose terms are all +-0), then at [n] the
    number of places.  Each tile's slots go to the places the compact
    table of the same bins (``planar.compact_bins`` with ``k_chunk``) holds
    them at: the compact table's places are its positions.  Built on the
    tensor's device with no host read (a captured step builds it)."""
    n = flat.numel()
    nt = counts.numel()
    k = n // nt
    pos = torch.arange(n, dtype=torch.int32, device=flat.device).reshape(nt, k)
    held = (flat < t_count).reshape(nt, k) & (pos % k < counts.reshape(nt, 1))
    if degenerate is not None:
        held = held & ~degenerate[flat.clamp(max=t_count - 1)].reshape(nt, k)
    total = -(-n // k_chunk) * k_chunk
    places, _, _, _ = compact_bins(torch.where(held, pos, -1), counts, -1, k_chunk, total)
    out = torch.empty(n + 1, dtype=torch.int32, device=flat.device)
    out[:n] = places[:n]  # the compact layout of tiles of at most K slots fits in n
    out[n:] = torch.clamp(-(-counts.clamp(max=k) // k_chunk) * k_chunk, max=k).sum()
    return out


def live_positions(tab: torch.Tensor) -> torch.Tensor:
    """The table positions of the slots whose terms are not all +-0 (K1's
    static table ``tab``: its last row, the degenerate flag, clear), in
    table order (int64): tile by tile, in either layout."""
    return (tab[-1] <= 0.5).nonzero()[:, 0]


def _check_pack_inputs(mvpm, tab, n_ch, name):
    dev = mvpm.device
    if dev.type != "cuda":
        raise ValueError(
            f"{name}: unsupported device {dev} (the kernel runs on CUDA "
            "tensors; CPU tensors take planar.pack_binned through "
            "pack_binned_auto)"
        )
    _check(mvpm, "mvpm", torch.float32, 2, dev)
    _check(tab, "tab", torch.float32, 2, dev)
    if mvpm.shape[1] != 20:
        raise ValueError(f"mvpm: expected (B, 20), got {tuple(mvpm.shape)}")
    if not 0 <= n_ch <= MAX_CHANNELS or tab.shape[0] != 9 + 3 * n_ch + 2:
        raise ValueError(f"tab: {tab.shape[0]} rows for n_ch={n_ch}")


def pack_fwd(mvpm: torch.Tensor, tab: torch.Tensor, sil_b: torch.Tensor,
             n_ch: int) -> torch.Tensor:
    """K1: the (B, 32, n) bin-ordered table (csrc/pack.cu).  CUDA only."""
    _check_pack_inputs(mvpm, tab, n_ch, "pack_fwd")
    b, n = mvpm.shape[0], tab.shape[1]
    _check(sil_b, "sil_b", torch.float32, 2, mvpm.device)
    if tuple(sil_b.shape) != (b, n):
        raise ValueError(f"sil_b: expected {(b, n)}, got {tuple(sil_b.shape)}")
    out = torch.empty((b, PACKED_WIDTH, n), dtype=torch.float32, device=mvpm.device)
    kernels.launch(
        "dd_pack_fwd", "pack_fwd",
        mvpm.data_ptr(), tab.data_ptr(), sil_b.data_ptr(), b, n, n_ch,
        out.data_ptr(),
    )
    return out


def _check_g(mvpm, tab, g):
    b, n = mvpm.shape[0], tab.shape[1]
    if tuple(g.shape) != (b, PACKED_WIDTH, n):
        raise ValueError(f"g: expected {(b, PACKED_WIDTH, n)}, got {tuple(g.shape)}")


def pack_bwd(mvpm: torch.Tensor, tab: torch.Tensor, g: torch.Tensor,
             n_ch: int, order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: (B, 19) = [d_mvp (16, row-major), d_mtx row 2 (3)] from the
    table's cotangent g (B, 32, n), summed at the compact layout's places
    (csrc/pack.cu): the table's positions (a compact table, ``order``
    None), or the uniform table's :func:`slot_order`.  CUDA only."""
    _check_pack_inputs(mvpm, tab, n_ch, "pack_bwd")
    b, n = mvpm.shape[0], tab.shape[1]
    _check(g, "g", torch.float32, 3, mvpm.device)
    _check_g(mvpm, tab, g)
    if order is not None:
        _check(order, "order", torch.int32, 1, mvpm.device)
        if order.numel() != n + 1:
            raise ValueError(f"order: expected ({n + 1},), got {tuple(order.shape)}")
    partial = torch.empty((b * -(-n // _CHUNK) * N_OUT,), dtype=torch.float32,
                          device=mvpm.device)
    out = torch.empty((b, N_OUT), dtype=torch.float32, device=mvpm.device)
    kernels.launch(
        "dd_pack_bwd", "pack_bwd",
        mvpm.data_ptr(), tab.data_ptr(), g.data_ptr(),
        None if order is None else order.data_ptr(), b, n, n_ch,
        partial.data_ptr(), out.data_ptr(),
    )
    return out


def pack_bwd_plain(mvpm: torch.Tensor, tab: torch.Tensor, g: torch.Tensor,
                   n_ch: int) -> torch.Tensor:
    """K2's plain version, (B, 19): ``planar.pack_binned``'s autograd on
    the live slots alone (:func:`live_positions`), gathered in table order
    into one contiguous table, so each of its sums over slots is one fixed
    reduction of the live slots' terms in that order: where the table's
    padding sits and how long the table is do not reach it."""
    _check_g(mvpm, tab, g)
    pos = live_positions(tab)
    t, gl = tab[:, pos], g[:, :, pos].contiguous()
    with torch.enable_grad():
        s = [mvpm[:, i : i + 1].clone().requires_grad_(True) for i in range(N_OUT)]
        pk = [[t[3 * k + c][None] for c in range(3)] for k in range(3)]

        def transform(r, trans):  # planar.pack_binned's order
            return [s[r] * pk[k][0] + s[r + 1] * pk[k][1] + s[r + 2] * pk[k][2] + trans
                    for k in range(3)]

        cp = {name: transform(4 * i, s[4 * i + 3])
              for i, name in enumerate(("x", "y", "z", "w"))}
        zrot = transform(16, torch.zeros_like(s[16]))
        attrs = [[t[9 + k * n_ch + c][None] for c in range(n_ch)] for k in range(3)]
        zeros = t.new_zeros((pos.numel(),))
        packed = packed_planar(cp, attrs if n_ch else None, zrot, t[10 + 3 * n_ch] > 0.5,
                               zeros, zeros[None])
        return torch.cat(torch.autograd.grad(packed, s, gl), dim=1)


class PackBinned(torch.autograd.Function):
    """The bin-ordered table, differentiable in mvp and mtx only (the table
    and silhouette bits are constants; counterpart of
    ``pack_binned_pallas``): on the card K1 forward, K2 backward; on the
    CPU ``table()``, ``planar.pack_binned``'s table, forward and
    :func:`pack_bwd_plain` backward.  ``order``: K2's places (None: the
    table's positions)."""

    @staticmethod
    def forward(ctx, mvp, mtx, tab, sil_b, n_ch, order, table):
        mvpm = _mvpm(mvp.detach(), mtx.detach())
        ctx.save_for_backward(mvpm, tab, order)
        ctx.n_ch = n_ch
        return pack_fwd(mvpm, tab, sil_b, n_ch) if table is None else table()

    @staticmethod
    def backward(ctx, g):
        mvpm, tab, order = ctx.saved_tensors
        if g.device.type == "cpu":
            d = pack_bwd_plain(mvpm, tab, g.contiguous(), ctx.n_ch)
        else:
            d = pack_bwd(mvpm, tab, g.contiguous(), ctx.n_ch, order)
        b = d.shape[0]
        d_mvp = d[:, :16].reshape(b, 4, 4)
        d_mtx = d.new_zeros((b, 4, 4))
        d_mtx[:, 2, :3] = d[:, 16:N_OUT]
        return d_mvp, d_mtx, None, None, None, None, None


def _eligible(pos_c: torch.Tensor, corner_attrs: Optional[torch.Tensor]) -> bool:
    """The reference's rules (``pack_binned_auto``, :472-485): static shared
    vertices and static per-corner attributes, read from the inputs alone.
    K2 differentiates the pose only, so traced vertices or attributes
    (vertex or appearance optimization) would silently lose their
    gradients."""
    if pos_c.dim() != 2 or pos_c.requires_grad:
        return False
    if corner_attrs is not None and (
        corner_attrs.dim() != 3 or corner_attrs.requires_grad
        or corner_attrs.shape[-1] > MAX_CHANNELS
    ):
        return False
    return True


def pack_binned_auto(
    pos_c: torch.Tensor,
    mvp: torch.Tensor,
    mtx: torch.Tensor,
    flat: torch.Tensor,
    corner_attrs: Optional[torch.Tensor],
    sil: torch.Tensor,
    degenerate: Optional[torch.Tensor],
    t_count: int,
    static_table: Tuple[torch.Tensor, int],
    order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``planar.pack_binned``'s table, (B, 32, n_slots): K1/K2 for CUDA
    tensors, the plain ``planar.pack_binned`` and :func:`pack_bwd_plain`
    for CPU tensors; anything else raises.  ``order`` is K2's places: the
    uniform table's :func:`slot_order`, None for a table in the compact
    layout (its places are its positions).  Inputs that :func:`_eligible`
    refuses (a gradient to the vertices or the colours, per-hypothesis
    colours) take the plain pack on every device, whose autograd carries
    d_attrs, as the reference's return of None sends them to its XLA
    pack; the 'pack_plain' counter counts them."""
    flat = flat.reshape(-1)
    if mvp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_binned_auto: unsupported device {mvp.device}")
    if not _eligible(pos_c, corner_attrs):
        kernels.count("pack_plain")
        return pack_binned(pos_c, mvp, mtx, flat, corner_attrs, sil, degenerate,
                           t_count, static_table)
    tab, n_ch = _static_table(flat, t_count, static_table)
    if mvp.device.type == "cpu":
        def table():
            return pack_binned(pos_c, mvp, mtx, flat, corner_attrs, sil, degenerate,
                               t_count, static_table)

        return PackBinned.apply(mvp, mtx, tab, None, n_ch, order, table)
    sil_b = sil[:, flat.clamp(max=t_count - 1)].to(torch.float32).contiguous()
    return PackBinned.apply(mvp, mtx, tab.contiguous(), sil_b, n_ch, order, None)
