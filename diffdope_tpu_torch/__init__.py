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

from diffdope_tpu_torch.camera import Camera
from diffdope_tpu_torch.config import ConfigNode, load_config
from diffdope_tpu_torch.diffdope import DiffDope
from diffdope_tpu_torch.geometry import (
    matrix33_from_quat,
    matrix44_from_quat_trans,
    opencv_to_opengl,
    opengl_to_opencv,
    projection_from_intrinsics,
    quat_from_axis_angle,
    quat_from_matrix33,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    xfm_points,
    xfm_vectors,
)
from diffdope_tpu_torch.image import Image, Scene
from diffdope_tpu_torch.losses import (
    LOSS_REGISTRY,
    dist_batch_lr,
    l1_depth_with_mask,
    l1_mask,
    l1_rgb_with_mask,
    register_loss,
    select_losses,
)
from diffdope_tpu_torch.mesh import Mesh, build_edge_adjacency, load_mesh
from diffdope_tpu_torch.metrics import add_auc, add_metric, adds_metric, object_diameter
from diffdope_tpu_torch.object3d import Object3D
from diffdope_tpu_torch.optimize import (
    RefineResult,
    argmin_hypothesis,
    pose_matrix,
    pose_params,
    refine,
)
from diffdope_tpu_torch.render import antialias, interpolate, rasterize, texture
from diffdope_tpu_torch.render.fused_loss import raster_loss_compact
from diffdope_tpu_torch.render.pipeline import (
    make_fused_loss,
    render_batch,
    render_rgb_mask,
)
from diffdope_tpu_torch.testing import icosphere

__version__ = "0.1.0"
