"""Shard the hypothesis batch over ranks (counterpart of
``diffdope_tpu/parallel.py``).

The batch of pose hypotheses is the one axis to split: each rank of a
``torch.distributed`` group runs the whole refinement (:func:`refine`) on
its own B/n slice, so its kernels' batch extent and its optimizer state
shrink with n.  The ground truth, the mesh and the projection are the
same on every rank.  Each rank bins over the union of every rank's
hypotheses (``optimize.refine(process_group=)`` under
``planar.union_over``), so its bins, cull and table layout are the
unsharded run's: the table's slot count a hypothesis does not shrink
with n, only the number of hypotheses.  The collectives inside a step
are that union's all-reduce, and the all-reduces of the logged total
and telemetry and of the gradients of shared appearance leaves; the
result is reassembled once at the end, so every rank returns the global
one.

One process drives one rank, PyTorch's idiom for several cards: launch
with ``torchrun --nproc-per-node N`` (or ``python -m
torch.distributed.run``).  Each rank takes the card of its local rank
when there are enough cards (NCCL), else the ranks share the card, or
run on the CPU (gloo).  The reassembly writes each rank's slice into a
zeroed global buffer and all-reduces it (SUM), which gloo supports on
CUDA tensors (its ``all_gather`` does not).
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch

from diffdope_tpu_torch.optimize import POSE_KEYS, RefineResult, refine

__all__ = ["HypothesisMesh", "hypothesis_mesh", "shard_params", "replicate",
           "refine_sharded", "rank_device"]

#: the environment a torchrun rank finds
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class HypothesisMesh(NamedTuple):
    """The ranks that share the hypothesis batch: the process group, this
    process's rank in it, the group's size n and the rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device


def _local_rank() -> int:
    import torch.distributed as dist

    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))


def _local_world() -> int:
    import torch.distributed as dist

    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU only when ``device`` asks for it
    ("cpu"); else a card, the one ``device`` names or (None or "cuda") the
    card of the local rank, modulo the cards there are, made the current
    device (the kernels launch on the current device's stream).  Raises
    RuntimeError, naming the missing card, when there is none: nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank_device: no CUDA card is available for device {str(dev)!r}; "
            "pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def hypothesis_mesh(n_devices: Optional[int] = None, device=None) -> HypothesisMesh:
    """The default process group as a hypothesis mesh of ``n_devices`` ranks
    (the reference's 1-D device mesh, ``parallel.py:44-49``).

    A group already initialized is taken as it is.  Else it is initialized
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card): NCCL when each local
    rank has a card of its own, gloo when the ranks share a card or run on
    the CPU (``device`` "cpu"); a caller that wants another timeout than
    torch's initializes the group itself.  Raises RuntimeError when there is
    neither a group nor that environment, and ValueError when the group's
    size is not ``n_devices``.  On a card, local rank 0 builds the kernels
    before any other rank loads them."""
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("hypothesis_mesh: torch.distributed is not available")
    if not dist.is_initialized():
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "hypothesis_mesh: no process group is initialized and the torchrun "
                f"environment is missing {', '.join(missing)}: launch with torchrun "
                "--nproc-per-node N, or call torch.distributed.init_process_group first")
        dev = rank_device(device)
        own_cards = dev.type == "cuda" and torch.cuda.device_count() >= _local_world()
        dist.init_process_group("nccl" if own_cards else "gloo", init_method="env://")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size != int(n_devices):
        raise ValueError(
            f"hypothesis_mesh: the process group has {size} ranks, not {n_devices}")
    dev = rank_device(device)
    if dev.type == "cuda":
        from diffdope_tpu_torch import kernels

        if _local_rank() == 0:
            kernels.build()
        dist.barrier()
    return HypothesisMesh(dist.group.WORLD, rank, size, dev)


def _rank_slice(mesh: HypothesisMesh, b: int) -> slice:
    if b % mesh.size != 0:
        raise ValueError(f"batchsize {b} not divisible by mesh size {mesh.size}")
    b_local = b // mesh.size
    return slice(mesh.rank * b_local, (mesh.rank + 1) * b_local)


def shard_params(params: Dict[str, torch.Tensor], mesh: HypothesisMesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slice of (B,)-leading tensors, on its device."""
    return {k: v[_rank_slice(mesh, v.shape[0])].to(mesh.device) for k, v in params.items()}


def replicate(tree, mesh: HypothesisMesh):
    """A (nested) dict of tensors, each on this rank's device (every rank
    holds the whole)."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return torch.as_tensor(tree).to(mesh.device)


def _gather(local: torch.Tensor, mesh: HypothesisMesh, dim: int) -> torch.Tensor:
    """The global tensor of every rank's ``local`` slice along ``dim``:
    each rank writes its slice into a zeroed buffer, summed over the
    ranks (x + 0 is x, so the values are the ranks' own)."""
    import torch.distributed as dist

    b_local = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = b_local * mesh.size
    out = local.new_zeros(shape)
    out.narrow(dim, mesh.rank * b_local, b_local).copy_(local)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def refine_sharded(
    params0: Dict[str, torch.Tensor],
    render_fn,
    loss_fns: Sequence,
    gt: Dict[str, torch.Tensor],
    learning_rates: torch.Tensor,
    weights: Dict[str, float],
    mesh: HypothesisMesh,
    extra_params: Optional[Dict[str, torch.Tensor]] = None,
    **refine_kwargs,
) -> RefineResult:
    """:func:`refine` with the hypothesis batch sharded over ``mesh``
    (``parallel.py:62-204``), on every rank of it.

    ``params0`` and ``learning_rates`` are global (B leading); B must be
    divisible by n.  Each rank refines its B/n slice with the objective
    scaled by 1/n (its share of the global batch mean) and its own slice
    of the loss scales (the fused loss takes them per call), the logged
    total and telemetry all-reduced every step.  ``extra_params``
    (appearance leaves) are shared: their gradients are summed over the
    ranks, so every rank keeps the same values.  Every binning inside the
    run takes the union over all the ranks' hypotheses (``refine`` under
    a group), so each rank's bins, cull and table layout are the
    unsharded run's: with B and n powers of two a hypothesis then takes
    the unsharded run's steps bit for bit.  (The reference's shards bin
    their own hypotheses, so a hypothesis's render and the order of K2's
    sums depend on which hypotheses share its shard.)

    Every rank returns the global result: params, ``mtx_history``,
    ``losses_values``, ``total_loss``, the telemetry, and the optimizer
    state with its pose leaves reassembled (Adam's moments; the step
    count and the shared leaves' moments as they are).  Resuming from an
    ``opt_state`` is refused, as the reference refuses it."""
    b = params0["qx"].shape[0]
    if b % mesh.size != 0:
        raise ValueError(f"batchsize {b} not divisible by mesh size {mesh.size}")
    if refine_kwargs.get("opt_state") is not None:
        raise NotImplementedError(
            "resuming refine_sharded from an opt_state is not supported; "
            "use a fresh run (the LR schedule is stateless in step count)")
    local = shard_params(params0, mesh)
    lrs = (None if learning_rates is None
           else torch.as_tensor(learning_rates)[_rank_slice(mesh, b)].to(mesh.device))
    res = refine(local, render_fn, tuple(loss_fns), gt, lrs, weights,
                 extra_params=extra_params, loss_scale=1.0 / mesh.size,
                 process_group=mesh.group, **refine_kwargs)

    params = {k: (_gather(v, mesh, 0) if k in local else v) for k, v in res.params.items()}
    opt_state = dict(res.opt_state)
    for moment in ("mu", "nu"):
        if moment in opt_state:
            opt_state[moment] = {k: (_gather(v, mesh, 0) if k in POSE_KEYS else v)
                                 for k, v in opt_state[moment].items()}
    return RefineResult(
        params=params,
        mtx_history=_gather(res.mtx_history, mesh, 1),
        losses_values={k: _gather(v, mesh, 1) for k, v in res.losses_values.items()},
        total_loss=res.total_loss,
        telemetry=res.telemetry,
        opt_state=opt_state,
    )
