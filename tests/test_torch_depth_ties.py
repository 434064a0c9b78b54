"""The depth term's sign ties between the fused and the unfused route
(``chip_smoke.depth_ties`` / ``untie_depth``, which phase 14 uses to hold
the routes' init gradients to each other), on the CPU at 240x135.

Both routes compute |attr_z + gt depth + t_z| * seg0, in different
association orders; where the residual is within a rounding of 0 they can
differentiate it in opposite directions.  Here the gt depth is the init
render's own depth on the gt mask, so the residual is 0 up to rounding at
every pixel the render and the mask share: the ties must be found, and
with the gt depth moved off them the init pose gradients of the two
routes agree at rtol 2e-4, atol 1e-6, as the kernel-free routes do
everywhere else."""

import importlib.util
from pathlib import Path

import numpy as np
import torch
from torch_scene import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_depth_ties_account_for_the_routes_gradient_gap():
    from diffdope_tpu_torch.image import Image, Scene
    from diffdope_tpu_torch.optimize import pose_matrix

    cs = _chip_smoke()
    dd, _, _ = cs.diffdope_session(True, losses={"l1_depth_with_mask": True},
                                   hyper={"batchsize": 2}, device="cpu", resize=0.125)
    gt = dd.gt_tensors
    mtx0 = pose_matrix(dd.object3d.initial_params(dd.batchsize, "cpu"))[0]
    with torch.no_grad():
        depth0 = dd._make_render_fn()(mtx0)["depth"][0].numpy()
    seg = gt["segmentation"][..., 0] > 0
    dd.set_scene(Scene(tensor_rgb=Image(img_tensor=gt["rgb"]),
                       tensor_depth=Image(img_tensor=np.where(seg, depth0, gt["depth"]),
                                          depth=True),
                       tensor_segmentation=Image(img_tensor=gt["segmentation"])))

    ties = cs.depth_ties(dd)
    assert ties.shape == seg.shape and 0 < int(ties.sum()) <= int(seg.sum())
    assert not bool(ties[torch.as_tensor(~seg)].any()), "a tie outside the gt mask"
    moved = cs.untie_depth(dd, ties)
    changed = moved["depth"] != dd.gt_tensors["depth"]
    np.testing.assert_array_equal(changed, ties.numpy())
    fused, unfused = cs.step0_grads(dd, moved)
    assert cs.grad_gap(fused, unfused) <= 1.0
