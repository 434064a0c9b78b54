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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.planar import pack_binned
from diffdope_tpu_torch.render.raster import _check
from diffdope_tpu_torch.render.shade import PACKED_WIDTH

#: K2's output per hypothesis: d_mvp (16, row-major), d_mtx row 2 (3)
N_OUT = 19
#: slots per K2 block (csrc/pack.cu kChunk): the partial-sum scratch size
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


def pack_bwd(mvpm: torch.Tensor, tab: torch.Tensor, g: torch.Tensor,
             n_ch: int) -> torch.Tensor:
    """K2: (B, 19) = [d_mvp (16, row-major), d_mtx row 2 (3)] from the
    table's cotangent g (B, 32, n) (csrc/pack.cu).  CUDA only."""
    _check_pack_inputs(mvpm, tab, n_ch, "pack_bwd")
    b, n = mvpm.shape[0], tab.shape[1]
    _check(g, "g", torch.float32, 3, mvpm.device)
    if tuple(g.shape) != (b, PACKED_WIDTH, n):
        raise ValueError(f"g: expected {(b, PACKED_WIDTH, n)}, got {tuple(g.shape)}")
    partial = torch.empty((b * -(-n // _CHUNK) * N_OUT,), dtype=torch.float32,
                          device=mvpm.device)
    out = torch.empty((b, N_OUT), dtype=torch.float32, device=mvpm.device)
    kernels.launch(
        "dd_pack_bwd", "pack_bwd",
        mvpm.data_ptr(), tab.data_ptr(), g.data_ptr(), b, n, n_ch,
        partial.data_ptr(), out.data_ptr(),
    )
    return out


class PackBinned(torch.autograd.Function):
    """The bin-ordered table on the card: K1 forward, K2 backward
    (counterpart of ``pack_binned_pallas``).  Differentiable in mvp and mtx
    only; the table and silhouette bits are constants."""

    @staticmethod
    def forward(ctx, mvp, mtx, tab, sil_b, n_ch):
        mvpm = _mvpm(mvp.detach(), mtx.detach())
        ctx.save_for_backward(mvpm, tab)
        ctx.n_ch = n_ch
        return pack_fwd(mvpm, tab, sil_b, n_ch)

    @staticmethod
    def backward(ctx, g):
        mvpm, tab = ctx.saved_tensors
        d = pack_bwd(mvpm, tab, g.contiguous(), ctx.n_ch)
        b = d.shape[0]
        d_mvp = d[:, :16].reshape(b, 4, 4)
        d_mtx = d.new_zeros((b, 4, 4))
        d_mtx[:, 2, :3] = d[:, 16:N_OUT]
        return d_mvp, d_mtx, None, None, None


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
) -> torch.Tensor:
    """``planar.pack_binned``'s table, (B, 32, n_slots): K1/K2 for CUDA
    tensors, the plain ``planar.pack_binned`` for CPU tensors; anything
    else raises.  Inputs that :func:`_eligible` refuses (a gradient to
    the vertices or the colours, per-hypothesis colours) take the plain
    pack on every device, whose autograd carries d_attrs, as the
    reference's return of None sends them to its XLA pack; the
    'pack_plain' counter counts them."""
    flat = flat.reshape(-1)
    if mvp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_binned_auto: unsupported device {mvp.device}")
    if not _eligible(pos_c, corner_attrs):
        kernels.count("pack_plain")
        return pack_binned(pos_c, mvp, mtx, flat, corner_attrs, sil, degenerate,
                           t_count, static_table)
    if mvp.device.type == "cpu":
        return pack_binned(pos_c, mvp, mtx, flat, corner_attrs, sil, degenerate,
                           t_count, static_table)
    tab, n_ch = _static_table(flat, t_count, static_table)
    sil_b = sil[:, flat.clamp(max=t_count - 1)].to(torch.float32).contiguous()
    return PackBinned.apply(mvp, mtx, tab.contiguous(), sil_b, n_ch)
