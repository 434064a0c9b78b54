"""Loss selection (counterpart of ``diffdope_tpu/losses.py:select_losses``).

On the fused path the loss math lives in the kernels
(render/fused_loss.py); what the caller chooses is which L1 terms are on
and their weights.  The per-pixel loss functions of the unfused path are
not ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: config key -> the term's log key (reference registration order)
LOSS_TERMS = {
    "l1_rgb_with_mask": "rgb",
    "l1_depth_with_mask": "depth",
    "l1_mask": "mask_selection",
}


def select_losses(cfg_losses) -> Tuple[List[str], Dict[str, float]]:
    """Enabled term names (in registration order) and the weights dict
    {'rgb', 'depth', 'mask'} from the config group."""
    names = [name for name in LOSS_TERMS if cfg_losses.get(name)]
    weights = {
        "rgb": float(cfg_losses.get("weight_rgb", 1.0)),
        "depth": float(cfg_losses.get("weight_depth", 1.0)),
        "mask": float(cfg_losses.get("weight_mask", 1.0)),
    }
    return names, weights
