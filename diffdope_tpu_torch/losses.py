"""Loss library (counterpart of ``diffdope_tpu/losses.py``).

Each loss is ``fn(renders, gt, learning_rates, weights) -> (scalar,
(log_key, per_hypothesis_values))``: an L1 difference (masked by the gt
segmentation where the reference masks), reduced to a per-hypothesis mean,
scaled by the per-hypothesis loss scales, meaned and weighted.  ``gt``
holds unbatched (H, W[, C]) tensors that broadcast over the hypotheses.

The unfused losses read ``render_batch``'s outputs; the fused route
(render/pipeline.make_fused_loss) computes the same three terms in the
kernels.  |x| differentiates as JAX's abs does: +1 at 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from diffdope_tpu_torch.render.fused_loss import _l1

LossFn = Callable[..., Tuple[torch.Tensor, Tuple[str, torch.Tensor]]]

LOSS_REGISTRY: Dict[str, LossFn] = {}


def register_loss(name: str):
    """Register a loss under ``name`` for config-driven selection."""

    def deco(fn: LossFn) -> LossFn:
        LOSS_REGISTRY[name] = fn
        return fn

    return deco


def dist_batch_lr(tensor: torch.Tensor, learning_rates: torch.Tensor,
                  axes: Sequence[int]) -> torch.Tensor:
    """(B, ...) -> (B,) means over ``axes``, times the (B,) loss scales."""
    return tensor.mean(dim=tuple(axes)) * learning_rates


def _image_channels(value, n: int = 3):
    """A render as a tuple of (B, H, W) planes: the channels layout's
    tuple, a shared single-channel (B, H, W), or stacked (B, H, W, C)."""
    if isinstance(value, (tuple, list)):
        return tuple(value)
    if value.dim() == 3:
        return (value,) * n
    return tuple(value[..., c] for c in range(value.shape[-1]))


@register_loss("l1_rgb_with_mask")
def l1_rgb_with_mask(renders, gt, learning_rates, weights):
    """L1 on rgb inside the gt segmentation (``losses.py:72-86``)."""
    rgb = _image_channels(renders["rgb"])
    per_hyp = 0.0
    for c in range(3):
        diff = _l1((rgb[c] - gt["rgb"][..., c]) * gt["segmentation"][..., c])
        per_hyp = per_hyp + diff.mean(dim=(1, 2))
    per_hyp = per_hyp / 3.0
    return (per_hyp * learning_rates).mean() * weights["rgb"], ("rgb", per_hyp * weights["rgb"])


@register_loss("l1_depth_with_mask")
def l1_depth_with_mask(renders, gt, learning_rates, weights):
    """L1 on depth inside the gt segmentation (``losses.py:89-95``)."""
    diff = _l1((renders["depth"] - gt["depth"]) * gt["segmentation"][..., 0])
    lr_diff = dist_batch_lr(diff, learning_rates, (1, 2))
    log = diff.mean(dim=(1, 2)) * weights["depth"]
    return lr_diff.mean() * weights["depth"], ("depth", log)


@register_loss("l1_mask")
def l1_mask(renders, gt, learning_rates, weights):
    """L1 between the antialiased mask and the gt segmentation
    (``losses.py:98-110``)."""
    mask = _image_channels(renders["mask"])
    per_hyp = 0.0
    for c in range(3):
        per_hyp = per_hyp + _l1(mask[c] - gt["segmentation"][..., c]).mean(dim=(1, 2))
    per_hyp = per_hyp / 3.0
    return ((per_hyp * learning_rates).mean() * weights["mask"],
            ("mask_selection", per_hyp * weights["mask"]))


def select_losses(cfg_losses) -> Tuple[Sequence[LossFn], Dict[str, float]]:
    """The enabled losses, in the reference's order, and the weights dict
    {'rgb', 'depth', 'mask'} from the config group."""
    fns = [LOSS_REGISTRY[name]
           for name in ("l1_rgb_with_mask", "l1_depth_with_mask", "l1_mask")
           if cfg_losses.get(name)]
    weights = {
        "rgb": float(cfg_losses.get("weight_rgb", 1.0)),
        "depth": float(cfg_losses.get("weight_depth", 1.0)),
        "mask": float(cfg_losses.get("weight_mask", 1.0)),
    }
    return fns, weights
