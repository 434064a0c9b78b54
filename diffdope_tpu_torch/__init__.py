"""diffdope_tpu_torch — the PyTorch/CUDA port of ``diffdope_tpu``.

Refines a batch of 6-DoF pose hypotheses by gradient descent through a
differentiable rasterizer, in PyTorch on one NVIDIA H100.  The Pallas TPU
kernels of the reference package become kernels written by hand for
Hopper (``csrc/``, built with nvcc at first use); every kernel has a plain
torch version beside it, which CPU tensors use.

This package imports torch and numpy only: never jax, and never
``diffdope_tpu`` (whose import pulls in jax).  Module names mirror the
reference's, so each counterpart is easy to find.
"""

from diffdope_tpu_torch.geometry import (
    matrix33_from_quat,
    matrix44_from_quat_trans,
    projection_from_intrinsics,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
)
from diffdope_tpu_torch.losses import select_losses
from diffdope_tpu_torch.mesh import build_edge_adjacency
from diffdope_tpu_torch.optimize import (
    RefineResult,
    argmin_hypothesis,
    pose_matrix,
    pose_params,
    refine,
)
from diffdope_tpu_torch.render.fused_loss import raster_loss_compact
from diffdope_tpu_torch.render.pipeline import make_fused_loss, render_rgb_mask
from diffdope_tpu_torch.testing import icosphere

__version__ = "0.1.0"
