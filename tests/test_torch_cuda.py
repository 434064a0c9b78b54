"""The port's hand kernels (K3-K6) against their plain torch versions, on
the card.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one.  On a machine with a card (the repo's conftest imports jax,
which that machine does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.bench import bench_problem, distinct_poses
from diffdope_tpu_torch.kernels.check import check_kernels
from diffdope_tpu_torch.optimize import pose_matrix

pytestmark = pytest.mark.cuda

RES = (64, 96)
B = 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(cuda):
    return bench_problem(RES, subdiv=2, batch=B, device=cuda)


@pytest.fixture(scope="module")
def params(problem):
    """Each hypothesis at a pose of its own."""
    return distinct_poses(problem["params0"], 0.01)


@pytest.fixture(scope="module")
def checks(problem, params):
    mtx, _, _ = pose_matrix(params)
    d_sums = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]],
                          device=mtx.device)
    return {row["name"]: row for row in check_kernels(problem["fn"], mtx, d_sums)}


@pytest.mark.parametrize(
    "kernel", ["K3_raster_fwd", "K4_raster_bwd", "K5_loss_fwd", "K6_loss_bwd"]
)
def test_kernel_matches_plain_on_card(checks, kernel):
    row = checks[kernel]
    assert row["ok"], row


def test_fused_loss_on_card_matches_cpu(problem, params):
    """The whole step (table, spanning op, total) on the card, through the
    kernels, against the same step on the CPU, through the plain versions:
    loss rtol 1e-5, pose gradients rtol 2e-4 / atol 1e-6."""
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    s = problem["scene"]

    def value_and_grad(fn, device):
        p = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        mtx, _, _ = pose_matrix(p)
        total, _ = fn(mtx)
        grads = torch.autograd.grad(total, list(p.values()))
        return total.detach().cpu(), {k: g.cpu() for k, g in zip(p, grads)}

    fn_cpu = make_fused_loss(
        s["proj"], s["pos"], s["tri"], RES, problem["gt"], problem["lrs"],
        problem["weights"], use_rgb=True, use_mask=True, edge_adj=s["edge_adj"],
        vtx_color=s["vtx_color"], compact_total=problem["compact_total"],
        device="cpu",
    )
    kernels.reset_launches()
    v_gpu, g_gpu = value_and_grad(problem["fn"], "cuda")
    assert all(n == 1 for n in kernels.launches.values()), kernels.launches
    v_cpu, g_cpu = value_and_grad(fn_cpu, "cpu")
    np.testing.assert_allclose(v_gpu.numpy(), v_cpu.numpy(), rtol=1e-5, atol=1e-7)
    for k in g_cpu:
        np.testing.assert_allclose(g_gpu[k].numpy(), g_cpu[k].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
