"""The comparison that decides ``correct``.

A refinement cannot be followed to its end by a plain renderer in the time
a run has, and each later step amplifies rounding: the bf16 lane of the
configurations rounds the rows' gradient, Adam's second step divides by
its square, SGD's steps of ~10 px move pixels across edges.  On the card
the program's terms and poses stay within 1e-4 of the reference's at step
0 and after the first update, and part from it by up to 7% after the
second and third (PERF.md).  So the reference checks the two ends of the
trajectory each by itself:

- the start, from the benchmark's own inputs: the reference takes the
  request's initial pose, the frame and the loss scales, and takes the
  first step itself (render, loss terms, autograd, the optimizer's
  update).  ``loss_gap`` is the widest gap between the program's logged
  terms of step 0 and the reference's (the rasterizer's ids and coverage,
  the shaded and antialiased image, the L1 sums); ``pose_gap`` the widest
  gap between the program's pose after the first update and the
  reference's, over the reference's move, in the pose's seven components
  (the unit quaternion, the translation) but those whose gradient is
  nought to rounding in the reference (the gradient through the pack's
  backward, and the optimizer's update).
- the end, from the program's state: the reference renders the batch of
  poses of the step the program kept and scores the kept hypothesis.
  ``kept_gap`` is the gap between that score and the one the program
  logged for the pose it returned (a returned pose that is no logged pose
  of the run reads infinite).

Each term's gap is taken against the larger of the reference's own value
and the median of the reference's step-0 values.  The hypotheses followed
are drawn from the seed, half from each half of the batch; where the
configuration culls back faces per batch, the whole batch is followed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import geometry as geo
from portbench.reference.optim import Optimizer
from portbench.reference.render import cull_keep, loss_terms, render

#: hypotheses a check follows, where the configuration does not need the batch
HYPOTHESES = 4
#: the updates the reference takes from the start
STEPS = 1
#: a pose component's step-0 gradient under this share of the median
#: component's is nought to rounding: its move is left out of ``pose_gap``
NOUGHT = 1e-3


def pick_hypotheses(batch: int, cull: bool, rng: np.random.Generator) -> np.ndarray:
    if cull or batch <= HYPOTHESES:
        return np.arange(batch)
    half = batch // 2
    lo = rng.choice(half, HYPOTHESES // 2, replace=False)
    hi = half + rng.choice(batch - half, HYPOTHESES - HYPOTHESES // 2, replace=False)
    return np.sort(np.concatenate([lo, hi]))


def _keep(problem, mesh, proj, mtx):
    return cull_keep(mesh, proj, mtx) if problem.cull else None


def follow(problem, mesh, proj, gt_rgb, gt_seg, q0, t0, hyps: np.ndarray):
    """The reference's first ``STEPS`` updates from (q0, t0) for hypotheses
    ``hyps``: terms (STEPS, nh) by key, poses (STEPS + 1, nh, 4, 4), and the
    first step's gradient (nh, 7) of the quaternion and the translation."""
    dev, dtype = proj.device, proj.dtype
    nh = len(hyps)
    params = {"q": torch.as_tensor(np.tile(q0, (nh, 1)), device=dev).to(dtype).requires_grad_(),
              "t": torch.as_tensor(np.tile(t0, (nh, 1)), device=dev).to(dtype).requires_grad_()}
    scales = torch.as_tensor(problem.scales[hyps], device=dev).to(dtype)
    opt = Optimizer(problem.optimizer, problem.base_lr, problem.lr_decay, problem.steps - 1)
    terms: Dict[str, List[np.ndarray]] = {}
    poses, grads = [], []
    for _ in range(STEPS):
        mtx = geo.pose_matrix(params["q"], params["t"])
        poses.append(mtx.detach().float().cpu().numpy())
        out = render(mesh, proj, mtx, problem.resolution, _keep(problem, mesh, proj, mtx.detach()),
                     drows_bf16=problem.drows_bf16 and dtype == torch.float32)
        step_terms = loss_terms(out, gt_rgb, gt_seg, problem.weights)
        objective = sum((v * scales).sum() for v in step_terms.values()) / problem.batch
        gq, gt_ = torch.autograd.grad(objective, [params["q"], params["t"]])
        grads.append(torch.cat([gq, gt_], dim=1).float().cpu().numpy())
        for k, v in step_terms.items():
            terms.setdefault(k, []).append(v.detach().float().cpu().numpy())
        opt.update(params, {"q": gq, "t": gt_})
        del out, step_terms, objective
    poses.append(geo.pose_matrix(params["q"], params["t"]).detach().float().cpu().numpy())
    return {k: np.stack(v) for k, v in terms.items()}, np.stack(poses), grads[0]


@torch.no_grad()
def score(problem, mesh, proj, gt_rgb, gt_seg, batch_mtx: np.ndarray) -> Dict[str, np.ndarray]:
    """The reference's terms (by key, (B,)) at a batch of the program's poses."""
    dev, dtype = proj.device, proj.dtype
    mtx = torch.as_tensor(batch_mtx, device=dev).to(dtype)
    out = render(mesh, proj, mtx, problem.resolution, _keep(problem, mesh, proj, mtx))
    return {k: v.float().cpu().numpy() for k, v in
            loss_terms(out, gt_rgb, gt_seg, problem.weights).items()}


def _worst(values) -> float:
    """The largest of ``values``; infinite where one is not a number."""
    v = np.asarray(values, np.float64)
    return float(np.max(v)) if np.isfinite(v).all() else float("inf")


def _gap(prog, ref, floor) -> float:
    return _worst(np.abs(np.asarray(prog, np.float64) - ref) / np.maximum(np.abs(ref), floor))


def _components(mtx: np.ndarray, like: Optional[np.ndarray] = None) -> np.ndarray:
    """(nh, 7) the unit quaternion (its sign that of ``like``'s) and the
    translation of poses (nh, 4, 4)."""
    m = np.asarray(mtx, np.float64)
    q = np.stack([geo.quat_from_matrix(r) for r in m[:, :3, :3]])
    if like is not None:
        q *= np.where((q * like[:, :4]).sum(axis=1, keepdims=True) < 0, -1.0, 1.0)
    return np.concatenate([q, m[:, :3, 3]], axis=1)


def _pose_gap(poses, ref_poses, grad0) -> float:
    """The distance of ``poses`` (nh, 4, 4) from the reference's after its
    first update, over the reference's own move, the widest over
    hypotheses; the pose components whose step-0 gradient in the reference
    is under ``NOUGHT`` of the median component's are left out: Adam
    moves them by round-off alone, in either direction."""
    start = _components(ref_poses[0])
    ref = _components(ref_poses[STEPS], start)
    prog = _components(poses, ref)
    g = np.abs(np.asarray(grad0, np.float64))
    live = g >= NOUGHT * np.median(g)
    moved = np.sqrt(((ref - start) ** 2 * live).sum(axis=1))
    off = np.sqrt(((prog - ref) ** 2 * live).sum(axis=1))
    return _worst(off / np.maximum(moved, 1e-30))


def _rel(a: float, ref: float, floor: float) -> float:
    return _worst([abs(a - ref) / max(abs(ref), floor)])


def compare(problem, mesh, proj, frames, checked: List[Dict], rng: np.random.Generator,
            ) -> Dict[str, float]:
    """The three gaps over the checked requests: each entry of ``checked``
    holds the request ('q0', 't0', 'frame') and the program's outputs."""
    gaps = {"loss_gap": 0.0, "pose_gap": 0.0, "kept_gap": 0.0}
    dtype = proj.dtype
    for item in checked:
        gt_rgb = frames["rgb"][item["frame"]].to(dtype)
        gt_seg = frames["seg"][item["frame"]].to(dtype)
        hyps = pick_hypotheses(problem.batch, problem.cull, rng)
        ref_terms, ref_poses, grad0 = follow(problem, mesh, proj, gt_rgb, gt_seg, item["q0"],
                                             item["t0"], hyps)
        out = item["outputs"]
        for k, ref in ref_terms.items():
            floor = np.median(np.abs(ref[0]))
            gaps["loss_gap"] = max(gaps["loss_gap"],
                                   _gap(out["terms"][k][:STEPS, hyps], ref, floor))
        gaps["pose_gap"] = max(gaps["pose_gap"],
                               _pose_gap(np.asarray(out["mtx"])[STEPS, hyps], ref_poses, grad0))
        if out["kept"] is None:
            gaps["kept_gap"] = float("inf")
            continue
        s, h = out["kept"]
        batch = out["kept_batch"]
        if not problem.cull:  # the hypotheses are independent: score the kept one alone
            batch, h = batch[h:h + 1], 0
        ref_kept = score(problem, mesh, proj, gt_rgb, gt_seg, batch)
        ref_total = sum(float(v[h]) for v in ref_kept.values())
        prog_total = sum(out["kept_terms"].values())
        floor = float(np.median(sum(ref_terms[k][0] for k in ref_terms)))
        gaps["kept_gap"] = max(gaps["kept_gap"], _rel(prog_total, ref_total, floor))
    return gaps


def control(problem, mesh, proj, low_mesh, low_proj, frames, checked: List[Dict],
            rng: np.random.Generator) -> Dict[str, float]:
    """The same three gaps with the reference computed in the lower
    precision (``low_mesh``, ``low_proj``: bfloat16) in the program's place,
    on the same requests and hypotheses: its own first steps, and its score
    at the poses the program kept."""
    gaps = {"loss_gap": 0.0, "pose_gap": 0.0, "kept_gap": 0.0}
    low = low_proj.dtype
    for item in checked:
        rgb, seg = frames["rgb"][item["frame"]], frames["seg"][item["frame"]]
        hyps = pick_hypotheses(problem.batch, problem.cull, rng)
        ref_terms, ref_poses, grad0 = follow(problem, mesh, proj, rgb, seg, item["q0"], item["t0"],
                                             hyps)
        low_terms, low_poses, _ = follow(problem, low_mesh, low_proj, rgb.to(low), seg.to(low),
                                         item["q0"], item["t0"], hyps)
        for k, ref in ref_terms.items():
            gaps["loss_gap"] = max(gaps["loss_gap"],
                                   _gap(low_terms[k], ref, np.median(np.abs(ref[0]))))
        gaps["pose_gap"] = max(gaps["pose_gap"], _pose_gap(low_poses[STEPS], ref_poses, grad0))
        out = item["outputs"]
        if out["kept"] is None:
            continue
        s, h = out["kept"]
        batch = out["kept_batch"]
        if not problem.cull:
            batch, h = batch[h:h + 1], 0
        ref_total = sum(float(v[h]) for v in score(problem, mesh, proj, rgb, seg, batch).values())
        low_total = sum(float(v[h]) for v in score(problem, low_mesh, low_proj, rgb.to(low),
                                                   seg.to(low), batch).values())
        floor = float(np.median(sum(ref_terms[k][0] for k in ref_terms)))
        gaps["kept_gap"] = max(gaps["kept_gap"], _rel(low_total, ref_total, floor))
    return gaps


def verdict(gaps: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, [(name, value, limit)]): every gap at most its limit.  A
    cell without limits is not correct."""
    rows = [(k, v, None if limits is None else limits.get(k)) for k, v in gaps.items()]
    ok = bool(rows) and all(lim is not None and np.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows
