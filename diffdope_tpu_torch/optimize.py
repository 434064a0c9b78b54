"""Pose-hypothesis refinement loop.

Counterpart of ``diffdope_tpu/optimize.py``.  The reference runs the
steps as one jitted ``lax.scan``; here ``refine`` captures one step
(value-and-grad and the optimizer update, on the fused loss
``fused_loss_fn`` or on ``render_fn`` + ``loss_fns``, the unfused route)
as a CUDA graph and replays it, or runs it eagerly on the CPU.  Both
optimizers follow optax's semantics (the reference's ``optax.sgd`` /
``optax.adam``), not ``torch.optim``'s: Adam with b1 0.9, b2 0.999 and
eps 1e-8 outside the square root, bias correction at count + 1, and the
learning-rate schedule evaluated at the pre-increment step count.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.geometry import matrix44_from_quat_trans, quat_multiply, quat_normalize
from diffdope_tpu_torch.render.planar import union_over

#: the pose leaves of the optimized parameters
POSE_KEYS = ("qx", "qy", "qz", "qw", "x", "y", "z")


class RefineResult(NamedTuple):
    """Outputs of a refinement run (stacked over steps)."""

    params: Dict[str, torch.Tensor]         # final pose params (B,) + extra leaves
    mtx_history: torch.Tensor               # (steps, B, 4, 4) pre-update poses
    losses_values: Dict[str, torch.Tensor]  # per-term logs, each (steps, B)
    total_loss: torch.Tensor                # (steps,)
    telemetry: Any = None                   # underscore log keys, (steps,)
    opt_state: Any = None                   # optimizer state (segmented runs)
    segment_times: Any = None               # [(steps, wall_s), ...] per segment


def pose_params(quat, trans, batchsize: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Seven (B,) float32 tensors, every hypothesis at the same pose."""
    q = torch.as_tensor(quat, dtype=torch.float32, device=device)
    t = torch.as_tensor(trans, dtype=torch.float32, device=device)
    ones = torch.ones((batchsize,), dtype=torch.float32, device=device)
    return {
        "qx": ones * q[0], "qy": ones * q[1], "qz": ones * q[2], "qw": ones * q[3],
        "x": ones * t[0], "y": ones * t[1], "z": ones * t[2],
    }


def pose_matrix(params: Dict[str, torch.Tensor]):
    """params -> ((B,4,4) matrix, (B,4) unit quat, (B,3) trans); the
    quaternion is normalized in the graph."""
    q = torch.stack([params["qx"], params["qy"], params["qz"], params["qw"]], dim=-1)
    q = quat_normalize(q)
    t = torch.stack([params["x"], params["y"], params["z"]], dim=-1)
    return matrix44_from_quat_trans(q, t), q, t


def draw_pose_jitter(batchsize: int, generator: torch.Generator, jitter_deg: float,
                     jitter_trans: float) -> Dict[str, torch.Tensor]:
    """The random draws of :func:`jitter_pose_params` (``optimize.py:81-
    125``), on the host from ``generator``: a rotation axis (B, 3) and a
    translation direction (B, 3), each standard normal, an angle (B,)
    uniform in [0, jitter_deg] (in radians) and a magnitude (B,) uniform in
    [0, jitter_trans].  Torch's RNG cannot reproduce ``jax.random``:
    parity tests pass the reference's draws to :func:`apply_pose_jitter`."""
    f32 = torch.float32
    axis = torch.randn((batchsize, 3), generator=generator, dtype=f32)
    angle = torch.rand((batchsize,), generator=generator, dtype=f32)
    direction = torch.randn((batchsize, 3), generator=generator, dtype=f32)
    magnitude = torch.rand((batchsize,), generator=generator, dtype=f32)
    return {"axis": axis, "angle": angle * float(np.deg2rad(jitter_deg)),
            "direction": direction, "magnitude": magnitude * float(jitter_trans)}


def apply_pose_jitter(params: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                      keep_first: bool = True) -> Dict[str, torch.Tensor]:
    """Each hypothesis rotated by its drawn angle about its drawn axis
    (applied before its own rotation, the product normalized) and moved by
    its drawn magnitude along its drawn direction; with ``keep_first``
    hypothesis 0 keeps the unjittered pose (its quaternion normalized),
    as the reference's ``jitter_pose_params`` does.  Computed on the host
    and moved to ``params``' device, so the card starts from the CPU's
    bits (its sin and cos may round otherwise)."""
    dev = params["qx"].device
    d = {k: tensor(v, "cpu") for k, v in draws.items()}
    pose = {k: params[k].detach().cpu() for k in POSE_KEYS}

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)

    half = 0.5 * d["angle"]
    dq = torch.cat([unit(d["axis"]) * torch.sin(half)[:, None],
                    torch.cos(half)[:, None]], dim=-1)
    q = quat_normalize(torch.stack([pose[k] for k in POSE_KEYS[:4]], dim=-1))
    qj = quat_normalize(quat_multiply(dq, q))
    t = torch.stack([pose[k] for k in POSE_KEYS[4:]], dim=-1)
    tj = t + unit(d["direction"]) * d["magnitude"][:, None]
    if keep_first:
        qj = torch.cat([q[:1], qj[1:]])
        tj = torch.cat([t[:1], tj[1:]])
    out = dict(params)
    out.update((k, v.to(dev)) for k, v in zip(POSE_KEYS, list(qj.unbind(-1))
                                                + list(tj.unbind(-1))))
    return out


def jitter_pose_params(params: Dict[str, torch.Tensor], generator: torch.Generator,
                       jitter_deg: float = 0.0, jitter_trans: float = 0.0,
                       keep_first: bool = True) -> Dict[str, torch.Tensor]:
    """Seeded per-hypothesis pose jitter (``optimize.py:81-125``): draw
    (:func:`draw_pose_jitter`) and apply (:func:`apply_pose_jitter`);
    magnitudes of 0 return ``params`` as they are."""
    if jitter_deg <= 0.0 and jitter_trans <= 0.0:
        return params
    draws = draw_pose_jitter(params["qx"].shape[0], generator, jitter_deg, jitter_trans)
    return apply_pose_jitter(params, draws, keep_first)


def draw_learning_rates(seed: int, batchsize: int, bounds: Sequence[float],
                        device="cuda") -> torch.Tensor:
    """Per-hypothesis loss scales, uniform in ``bounds``, from a seeded
    ``torch.Generator`` on the host (the same numbers on every device).
    They cannot reproduce ``jax.random``'s: parity tests pass the
    reference's scales in."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand((batchsize,), generator=gen, dtype=torch.float32)
    lo, hi = float(bounds[0]), float(bounds[1])
    return (u * (hi - lo) + lo).to(device)


def make_lr_schedule(base_lr: float, lr_decay: float, nb_iterations: int):
    """lr(step) = base_lr * lr_decay ** (step/nb + 1), in float32.

    Host scalars (numpy float32): :func:`refine` lays a run's values out in
    a device table once (the optimizers' ``tables``), so no step enqueues a
    host-to-device copy."""
    f32 = np.float32

    def schedule(step: int) -> np.float32:
        itf = f32(step) / f32(nb_iterations) + f32(1.0)
        return f32(base_lr) * np.power(f32(lr_decay), itf)

    return schedule


class SGD:
    """optax.sgd(learning_rate=schedule): p <- p - lr(count) * g."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        return {"count": 0}

    def tables(self, count: int, length: int, reciprocal: bool = False
               ) -> Dict[str, np.ndarray]:
        """The step scalars of counts ``count`` .. ``count + length - 1``,
        float32 (length,): 'neg_lr', -lr(count)."""
        return {"neg_lr": np.asarray([-self.schedule(count + i) for i in range(length)],
                                     np.float32)}

    def update(self, grads, state, params, row) -> None:
        """One step in place (under no_grad), ``row`` the step's entries of
        :meth:`tables` (0-dim tensors)."""
        for k, p in params.items():
            p.copy_(p + row["neg_lr"] * grads[k])


class Adam:
    """optax.adam(learning_rate=schedule), op for op."""

    def __init__(self, schedule, b1=0.9, b2=0.999, eps=1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, params):
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    def tables(self, count: int, length: int, reciprocal: bool = False
               ) -> Dict[str, np.ndarray]:
        """The step scalars of counts ``count`` .. ``count + length - 1``,
        float32 (length,): 'neg_lr' and the bias corrections 1 - b ** (count
        + 1), 'bc1' and 'bc2', or with ``reciprocal`` their float32
        reciprocals 'inv_bc1' and 'inv_bc2': the card divides a tensor by a
        host scalar as a product with its reciprocal, the CPU by a true
        division, and a step keeps the bits that division gave."""
        f32 = np.float32
        out = SGD(self.schedule).tables(count, length)
        for name, b in (("bc1", self.b1), ("bc2", self.b2)):
            bc = [f32(1) - np.power(f32(b), f32(count + i + 1)) for i in range(length)]
            if reciprocal:
                out["inv_" + name] = np.asarray([f32(1) / c for c in bc], np.float32)
            else:
                out[name] = np.asarray(bc, np.float32)
        return out

    def update(self, grads, state, params, row) -> None:
        """One step in place (under no_grad): the moments and the params."""
        b1, b2 = self.b1, self.b2
        for k, g in grads.items():
            mu = (1 - b1) * g + b1 * state["mu"][k]
            nu = (1 - b2) * g ** 2 + b2 * state["nu"][k]
            if "inv_bc1" in row:
                upd = (mu * row["inv_bc1"]) / (torch.sqrt(nu * row["inv_bc2"]) + self.eps)
            else:
                upd = (mu / row["bc1"]) / (torch.sqrt(nu / row["bc2"]) + self.eps)
            params[k].copy_(params[k] + row["neg_lr"] * upd)
            state["mu"][k].copy_(mu)
            state["nu"][k].copy_(nu)


def make_optimizer(name: str, base_lr: float, lr_decay: float, nb_iterations: int):
    sched = make_lr_schedule(base_lr, lr_decay, nb_iterations)
    if name == "sgd":
        return SGD(sched)
    if name == "adam":
        return Adam(sched)
    raise ValueError(f"unknown optimizer {name!r} (sgd | adam)")


def refine(
    params0: Dict[str, torch.Tensor],
    render_fn: Optional[Callable] = None,
    loss_fns: Sequence[Callable] = (),
    gt: Optional[Dict[str, torch.Tensor]] = None,
    learning_rates: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
    nb_iterations: int = 60,
    base_lr: float = 20.0,
    lr_decay: float = 0.1,
    optimizer: str = "sgd",
    opt_state: Any = None,
    num_steps: Optional[int] = None,
    fused_loss_fn: Optional[Callable] = None,
    extra_params: Optional[Dict[str, torch.Tensor]] = None,
    step_callback: Optional[Callable] = None,
    loss_scale: float = 1.0,
    process_group: Any = None,
    cuda_graph: bool = True,
) -> RefineResult:
    """Run ``nb_iterations + 1`` optimizer steps (or ``num_steps``, for a
    segment; ``nb_iterations`` still shapes the learning-rate schedule,
    which continues from ``opt_state``'s step count).

    Each step scores the poses with ``fused_loss_fn(mtx) -> (total, logs)``
    when given (``fused_loss_fn(mtx, gt)`` for a loss that takes its
    ground truth per call, ``make_fused_loss(gt=None)``: the reference's
    signature test, ``optimize.py:241-258``; a fused loss that takes a
    ``learning_rates`` keyword is handed this call's, so a shard scores
    its own slice), else with
    ``render_fn(mtx, **extra)`` and the sum of ``fn(renders, gt,
    learning_rates, weights)`` over ``loss_fns``.
    ``extra_params`` are further optimized leaves (the appearance: 'tex',
    'vtx_color' or 'corner_colors', ``optimize.py:173, 226-269``), passed
    to ``render_fn`` as keyword arguments and updated by the same optimizer
    as the pose; ``params`` of the result holds them too.
    Underscore log keys go to ``telemetry``.

    A step is a function of device state only, the counterpart of the
    reference's ``lax.scan`` body: the params and the optimizer's moments
    are buffers that the update writes in place, its learning rate and
    bias corrections come from tables laid out once per call and read at a
    step counter on the device, and its pose, total, logs and telemetry go
    into preallocated (steps, ...) buffers at that counter.  On a CUDA
    device (``cuda_graph``, the default) step 0 runs eagerly on a side
    stream, the warm-up a capture needs, under
    ``torch.cuda.set_sync_debug_mode("error")``; the step is then captured
    once as a CUDA graph (``torch.cuda.CUDAGraph``: the pose matrix, the
    loss with its kernels, ``torch.autograd.grad``, the update and the
    history writes) and replayed for every later step, and the graph and
    its memory pool are released when ``refine`` returns.  A step that
    waits for the host (a read of a tensor's value, a data-dependent
    shape, host data copied in) cannot be captured: ``refine`` raises,
    naming the loss and its route, and never falls back to the eager
    loop.  The steps run eagerly, one launch at a time, with
    ``cuda_graph=False``, on the CPU, and under ``process_group``, whose
    collectives (gloo's run on the host) are not captured.

    Nothing synchronizes with the host inside the loop, unless
    ``step_callback(step_index, total)`` is given: it is called after
    every step (replay) with that step's total loss (a 0-dim view of the
    total's history; reading it is the per-step host sync the reference's
    ``jax.debug.callback`` pays).

    ``loss_scale`` multiplies the objective (``parallel.refine_sharded``
    passes 1/n, so each rank's mean over its B/n hypotheses becomes its
    share of the global mean).  Under ``process_group`` (a
    ``torch.distributed`` group over the ranks that share the batch, the
    reference's ``axis_name``, ``optimize.py:177-178, 271-290``) every
    binning inside the run takes the union over the group's hypotheses
    (``planar.union_over``), so each rank lays out the unsharded run's
    table, where the reference's shards bin their own.  The logged total
    and the telemetry are all-reduced every step, so every rank logs the
    global values: MAX for the table's '_bin_*' counters (the same on
    every rank) and for '*_max' keys, SUM for the rest; so are the
    gradients of ``extra_params`` (SUM), which every rank shares.  The
    pose gradients need no collective: the hypotheses are independent.
    """
    if fused_loss_fn is None and render_fn is None:
        raise ValueError("refine needs fused_loss_fn or render_fn + loss_fns")
    if fused_loss_fn is not None and extra_params:
        raise ValueError("fused_loss_fn does not support extra_params")
    opt = make_optimizer(optimizer, base_lr, lr_decay, nb_iterations)
    extra_keys = tuple(extra_params or ())
    # the step's state: copies the run updates in place
    params = {k: v.detach().clone() for k, v in params0.items()}
    params.update({k: v.detach().clone() for k, v in (extra_params or {}).items()})
    dev = next(iter(params.values())).device
    # host arrays go to the device once: no step copies host data
    if learning_rates is not None and not isinstance(learning_rates, torch.Tensor):
        learning_rates = tensor(learning_rates, dev)
    if gt is not None:
        gt = {k: v if v is None or isinstance(v, torch.Tensor) else tensor(v, dev)
              for k, v in gt.items()}
    fused_sig = () if fused_loss_fn is None else inspect.signature(fused_loss_fn).parameters
    fused_takes_gt = len([p for p in fused_sig if p != "learning_rates"]) >= 2
    fused_kw = ({"learning_rates": learning_rates}
                if "learning_rates" in fused_sig and learning_rates is not None else {})
    if opt_state is None:
        state = opt.init(params)
    else:
        state = {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                     if isinstance(v, dict) else v) for k, v in opt_state.items()}
    length = nb_iterations + 1 if num_steps is None else num_steps
    tables = {k: torch.as_tensor(v, device=dev)
              for k, v in opt.tables(state["count"], length, dev.type == "cuda").items()}
    step_i = torch.zeros((1,), dtype=torch.int64, device=dev)
    # the histories by (kind, key), kind 'step' (the pose and the total) or
    # 'log', allocated by step 0 from its values' shapes on the caller's
    # stream (step 0 runs on a side stream under the graph)
    main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    hist: Dict[Tuple[str, str], torch.Tensor] = {}
    for p in params.values():
        p.requires_grad_(True)

    def objective(mtx):
        if fused_loss_fn is not None:
            return (fused_loss_fn(mtx, gt, **fused_kw) if fused_takes_gt
                    else fused_loss_fn(mtx, **fused_kw))
        renders = render_fn(mtx, **{k: params[k] for k in extra_keys})
        total = mtx.new_zeros(())
        logs = {k: v for k, v in renders.items() if k.startswith("_")}
        for fn in loss_fns:
            term, (key, values) = fn(renders, gt, learning_rates, weights)
            total = total + term
            logs[key] = values
        return total, logs

    def record(values: Dict[Tuple[str, str], torch.Tensor]) -> None:
        """Write the step's values into the histories at the counter."""
        if not hist:
            with contextlib.nullcontext() if main is None else torch.cuda.stream(main):
                for k, v in values.items():
                    hist[k] = v.new_empty((length,) + tuple(v.shape))
        for k, v in values.items():
            hist[k].index_copy_(0, step_i, v[None])

    def step() -> None:
        row = {k: t.index_select(0, step_i).reshape(()) for k, t in tables.items()}
        mtx, _, _ = pose_matrix(params)
        total, logs = objective(mtx)
        if loss_scale != 1.0:
            total = total * loss_scale
        # a leaf the render does not read (vertex colours under corner
        # colours) gets a zero gradient, as JAX's grad gives it
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if process_group is not None:
            total, logs = _all_reduce_step(grads, extra_keys, total.detach(), logs,
                                           process_group)
        with torch.no_grad():
            record({("step", "mtx"): mtx.detach(), ("step", "total"): total.detach(),
                    **{("log", k): v.detach() for k, v in logs.items()}})
            opt.update(grads, state, params, row)
            step_i.add_(1)

    def totals(i: int) -> torch.Tensor:
        return hist[("step", "total")][i]

    # under a group every binning takes the union over the ranks' hypotheses
    union = contextlib.nullcontext() if process_group is None else union_over(process_group)
    with union:
        if cuda_graph and main is not None and process_group is None:
            _replayed(step, length, step_callback, totals, main,
                      _describe(fused_loss_fn, render_fn))
        else:
            for i in range(length):
                step()
                if step_callback is not None:
                    step_callback(i, totals(i))
    state["count"] += length
    logs = {k: v for (kind, k), v in hist.items() if kind == "log"}
    return RefineResult(
        params={k: p.detach() for k, p in params.items()},
        mtx_history=hist[("step", "mtx")],
        losses_values={k: v for k, v in logs.items() if not k.startswith("_")},
        total_loss=hist[("step", "total")],
        telemetry={k: v for k, v in logs.items() if k.startswith("_")} or None,
        opt_state=state,
    )


def _describe(fused_loss_fn, render_fn) -> str:
    """The loss a step runs and its raster route, for an error message."""
    fn = fused_loss_fn if fused_loss_fn is not None else render_fn
    kind = "fused_loss_fn" if fused_loss_fn is not None else "render_fn + loss_fns"
    route = getattr(fn, "route", None) or "binned"
    return f"{kind} {getattr(fn, '__qualname__', fn)!r} (raster route {route})"


def _replayed(step: Callable[[], None], length: int, callback: Optional[Callable],
              totals: Callable[[int], torch.Tensor], main, what: str) -> None:
    """Run ``length`` steps on the card: step 0 eagerly on a side stream
    (the warm-up a capture needs: the kernels' library, autograd's first
    run) with any host sync an error, then the step captured once as a
    CUDA graph on that stream and replayed on ``main`` for every later
    step, each replay adding the launches its capture recorded."""
    side = torch.cuda.Stream(device=main.device)
    side.wait_stream(main)
    mode = torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        except RuntimeError as err:
            if "synchroniz" not in str(err):
                raise
            raise RuntimeError(f"refine: the step of {what} waits for the host, so it "
                               f"cannot be captured as a CUDA graph: {err}") from err
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    main.wait_stream(side)
    if callback is not None:
        callback(0, totals(0))
    if length == 1:
        return
    # captured on the side stream without torch.cuda.graph's set-up (a
    # synchronize, gc.collect and empty_cache on every call)
    graph = torch.cuda.CUDAGraph()
    try:
        with kernels.recording() as recorded, torch.cuda.stream(side):
            graph.capture_begin()
            try:
                step()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
    except RuntimeError as err:
        raise RuntimeError(f"refine: the step of {what} cannot be captured as a CUDA "
                           f"graph: {err}") from err
    for i in range(1, length):
        graph.replay()
        kernels.add_launches(recorded)
        if callback is not None:
            callback(i, totals(i))


def _all_reduce_step(grads, extra_keys, total, logs, group):
    """One step's collectives over ``group`` (the reference's psum/pmax
    under ``axis_name``): the shared leaves' gradients (SUM, in place),
    the total (SUM) and the telemetry (MAX for the union table's '_bin_*'
    counters, which every rank shares, and for '*_max'; else SUM, as
    '_crop_leak' counts the rank's own hypotheses); the per-hypothesis
    logs stay the rank's own."""
    import torch.distributed as dist

    for k in extra_keys:
        dist.all_reduce(grads[k], op=dist.ReduceOp.SUM, group=group)
    total = total.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    logs = dict(logs)
    for k, v in logs.items():
        if k.startswith("_"):
            v = v.detach().clone()
            shared = k.startswith("_bin_") or k.endswith("_max")
            op = dist.ReduceOp.MAX if shared else dist.ReduceOp.SUM
            dist.all_reduce(v, op=op, group=group)
            logs[k] = v
    return total, logs


def refine_segmented(
    params0: Dict[str, torch.Tensor],
    render_fn: Optional[Callable] = None,
    loss_fns: Sequence[Callable] = (),
    gt: Optional[Dict[str, torch.Tensor]] = None,
    learning_rates: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
    nb_iterations: int = 60,
    segment_steps: int = 40,
    progress_fn: Optional[Callable] = None,
    extra_params: Optional[Dict[str, torch.Tensor]] = None,
    **refine_kwargs,
) -> RefineResult:
    """:func:`refine` in segments of ``segment_steps`` steps, the optimizer
    state, the schedule's step count and the ``extra_params`` leaves
    carried across, so the result is the unsegmented run's.
    ``progress_fn(done_steps, total_steps, last_total_loss)`` is called
    after every segment (the one host sync of a segment, which also times
    it: ``segment_times``)."""
    total = nb_iterations + 1
    params, extra, opt_state = params0, extra_params, None
    parts, segment_times = [], []
    done = 0
    while done < total:
        n = min(segment_steps, total - done)
        t0 = time.perf_counter()
        res = refine(params, render_fn, loss_fns, gt, learning_rates, weights,
                     nb_iterations=nb_iterations, opt_state=opt_state, num_steps=n,
                     extra_params=extra, **refine_kwargs)
        last = float(res.total_loss[-1])
        segment_times.append((n, time.perf_counter() - t0))
        opt_state = res.opt_state
        params = {k: v for k, v in res.params.items() if k in params0}
        extra = {k: v for k, v in res.params.items() if k not in params0} or None
        parts.append(res)
        done += n
        if progress_fn is not None:
            progress_fn(done, total, last)

    def cat(get):
        return torch.cat([get(r) for r in parts], dim=0)

    telemetry = {k: cat(lambda r, k=k: r.telemetry[k])
                 for k in (parts[0].telemetry or {})}
    return RefineResult(
        params=res.params,
        mtx_history=cat(lambda r: r.mtx_history),
        losses_values={k: cat(lambda r, k=k: r.losses_values[k])
                       for k in parts[0].losses_values},
        total_loss=cat(lambda r: r.total_loss),
        telemetry=telemetry or None,
        opt_state=opt_state,
        segment_times=segment_times,
    )


def refine_with_restarts(
    params0: Dict[str, torch.Tensor],
    render_fn: Optional[Callable] = None,
    loss_fns: Sequence[Callable] = (),
    gt: Optional[Dict[str, torch.Tensor]] = None,
    learning_rates: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
    nb_iterations: int = 60,
    restarts: int = 1,
    restart_jitter_deg: float = 10.0,
    restart_jitter_trans: float = 0.02,
    draw_jitter: Optional[Callable] = None,
    segment_steps: Optional[int] = None,
    **refine_kwargs,
) -> RefineResult:
    """Basin-hopping refinement (``optimize.py:402-516``): the
    ``nb_iterations + 1`` steps in ``restarts + 1`` segments of ``(total -
    done) // (segments left)`` steps.  After each segment but the last,
    every hypothesis re-seeds at the best one's pose (the argmin over B of
    the mean logged term at the segment's last step), jittered by
    ``draw_jitter(B)``'s draws (:func:`apply_pose_jitter`; hypothesis 0
    exactly at the winner, no jitter at all when both magnitudes are 0),
    and the optimizer state, the schedule's step count included, resets.
    A segment runs in chunks of ``segment_steps``, the optimizer state
    carried across them.  ``draw_jitter`` defaults to
    :func:`draw_pose_jitter` from a generator seeded 0.  Histories, logs
    and telemetry are the segments' concatenated."""
    total = nb_iterations + 1
    n_seg = restarts + 1
    if draw_jitter is None:
        gen = torch.Generator().manual_seed(0)

        def draw_jitter(b):
            return draw_pose_jitter(b, gen, restart_jitter_deg, restart_jitter_trans)

    params, parts, done = params0, [], 0
    for seg in range(n_seg):
        n = (total - done) // (n_seg - seg)
        seg_done, opt_state = 0, None
        while seg_done < n:
            m = n if segment_steps is None else min(segment_steps, n - seg_done)
            res = refine(params, render_fn, loss_fns, gt, learning_rates, weights,
                         nb_iterations=nb_iterations, opt_state=opt_state, num_steps=m,
                         **refine_kwargs)
            params, opt_state = res.params, res.opt_state
            parts.append(res)
            seg_done += m
        done += n
        if seg < n_seg - 1:
            mean = torch.stack([v[-1] for v in res.losses_values.values()]).mean(dim=0)
            best = int(torch.argmin(mean))
            shared = {k: res.params[k][best].expand_as(res.params[k]).clone()
                      for k in POSE_KEYS}
            if restart_jitter_deg > 0.0 or restart_jitter_trans > 0.0:
                shared = apply_pose_jitter(shared, draw_jitter(shared["qx"].shape[0]))
            params = shared

    def cat(get):
        return torch.cat([get(r) for r in parts], dim=0)

    telemetry = {k: cat(lambda r, k=k: r.telemetry[k]) for k in (parts[0].telemetry or {})}
    return RefineResult(
        params=params,
        mtx_history=cat(lambda r: r.mtx_history),
        losses_values={k: cat(lambda r, k=k: r.losses_values[k])
                       for k in parts[0].losses_values},
        total_loss=cat(lambda r: r.total_loss),
        telemetry=telemetry or None,
    )


def argmin_hypothesis(losses_values: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Best hypothesis = argmin over B of the mean of every logged term at
    the last step (reference get_argmin)."""
    last = torch.stack([v[-1] for v in losses_values.values()], dim=0)
    return torch.argmin(last.mean(dim=0), dim=-1)


def argmin_step_hypothesis(losses_values: Dict[str, torch.Tensor],
                           rule: str = "best_step") -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (step, hypothesis) under the selection rule
    (``optimize.py:525-553``): 'best_step' takes the argmin of the mean
    logged term over the whole (step, hypothesis) history (the logged loss
    of step s scores the pre-update pose ``mtx_history[s]``, so the winner
    is never worse than the init); 'last_step' is the reference's
    get_argmin rule, the last step only."""
    mean = torch.stack(list(losses_values.values()), dim=0).mean(dim=0)  # (S, B)
    if rule == "last_step":
        return torch.tensor(mean.shape[0] - 1), torch.argmin(mean[-1], dim=-1)
    if rule != "best_step":
        raise ValueError(f"unknown argmin rule {rule!r} (best_step | last_step)")
    flat = torch.argmin(mean.reshape(-1), dim=-1)
    return flat // mean.shape[1], flat % mean.shape[1]
