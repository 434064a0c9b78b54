"""Pose-hypothesis refinement loop.

Counterpart of ``diffdope_tpu/optimize.py``.  The reference runs the
steps as one jitted ``lax.scan``, compiled once (``jit_refine``) and
called by every segment and restart; here :class:`CapturedRefine`
captures one step (value-and-grad and the optimizer update, on the fused
loss ``fused_loss_fn`` or on ``render_fn`` + ``loss_fns``, the unfused
route) as a CUDA graph once and replays it across its calls, or runs it
eagerly on the CPU; :func:`refine` is one call of one.  Both
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

from diffdope_tpu_torch import kernels, trace
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

    Host scalars (numpy float32): :class:`CapturedRefine` lays the values
    of its horizon out in a device table once (the optimizers' ``tables``),
    so no step enqueues a host-to-device copy."""
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
    which continues from ``opt_state``'s step count): one call of a
    :class:`CapturedRefine` built for it, which holds the step's buffers
    (and on the card its CUDA graph and the graph's memory pool) until
    ``refine`` returns.  A caller that refines again with the same loss
    (segments, restarts, repeated runs) keeps one :class:`CapturedRefine`
    instead and pays step 0 and the capture once.

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

    The step, its graph and its eager loop are :class:`CapturedRefine`'s:
    on a CUDA device (``cuda_graph``, the default) step 0 runs eagerly on
    a side stream under ``torch.cuda.set_sync_debug_mode("error")``, then
    the step is captured once and replayed for every later step; a step
    that waits for the host raises, naming the loss and its route, and
    never falls back to the eager loop.  The steps run eagerly with
    ``cuda_graph=False``, on the CPU, and under ``process_group``, whose
    collectives (gloo's run on the host) are not captured.

    Nothing synchronizes with the host inside the loop, unless
    ``step_callback(step_index, total)`` is given: it is called after
    every step (replay) with a copy of that step's total loss (0-dim, on
    the device; reading it is the per-step host sync the reference's
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
    count = 0 if opt_state is None else int(opt_state["count"])
    length = nb_iterations + 1 if num_steps is None else num_steps
    once = CapturedRefine(render_fn, loss_fns, weights, nb_iterations, base_lr, lr_decay,
                          optimizer, fused_loss_fn, loss_scale, process_group, cuda_graph,
                          horizon=max(nb_iterations + 1, count + length))
    return once(params0, gt=gt, learning_rates=learning_rates, opt_state=opt_state,
                num_steps=num_steps, extra_params=extra_params, step_callback=step_callback)


def _describe(fused_loss_fn, render_fn) -> str:
    """The loss a step runs and its raster route, for an error message."""
    fn = fused_loss_fn if fused_loss_fn is not None else render_fn
    kind = "fused_loss_fn" if fused_loss_fn is not None else "render_fn + loss_fns"
    route = getattr(fn, "route", None) or "binned"
    return f"{kind} {getattr(fn, '__qualname__', fn)!r} (raster route {route})"


def _layout(v: Optional[torch.Tensor]):
    """What a buffer copied from ``v`` must match: shape and dtype (None
    for None); the buffers are contiguous whatever ``v``'s strides."""
    return None if v is None else (tuple(v.shape), v.dtype)


def _buffer(v: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(v.shape, dtype=v.dtype, device=device)


class _Trace:
    """The buffers of one layout of a :class:`CapturedRefine`'s inputs, at
    addresses fixed for its lifetime: the leaves, the optimizer's moments,
    the schedule tables over the horizon, the schedule and history row
    counters, the histories (allocated by the first step, a row for each
    step of the horizon), the ground truth and the loss scales; on the
    card also the side stream, the step's device stamps (``trace``: a row
    for each step of the horizon, ``trace.POINTS`` columns, 0 where a
    point was not reached), and the CUDA graph once captured with the
    launches its capture recorded and its memory pool's size."""

    def __init__(self, key, leaves, extra_keys, gt, lrs, opt, horizon: int):
        self.key, self.extra_keys = key, extra_keys
        self.dev = next(iter(leaves.values())).device
        self.params = {k: _buffer(v, self.dev).requires_grad_(True)
                       for k, v in leaves.items()}
        self.state = opt.init(self.params)
        del self.state["count"]  # the schedule counter's, on the device
        self.tables = {k: torch.as_tensor(v, device=self.dev)
                       for k, v in opt.tables(0, horizon, self.dev.type == "cuda").items()}
        self.sched_i = torch.zeros((1,), dtype=torch.int64, device=self.dev)
        self.row_i = torch.zeros((1,), dtype=torch.int64, device=self.dev)
        self.rows = horizon
        # by (kind, key), kind 'step' (the pose and the total) or 'log'
        self.hist: Dict[Tuple[str, str], torch.Tensor] = {}
        self.gt = None if gt is None else {k: None if v is None else _buffer(v, self.dev)
                                           for k, v in gt.items()}
        self.lrs = None if lrs is None else _buffer(lrs, self.dev)
        cuda = self.dev.type == "cuda"
        self.home = torch.cuda.current_stream(self.dev) if cuda else None
        self.side = torch.cuda.Stream(device=self.dev) if cuda else None
        self.stamps = (torch.zeros((horizon, trace.POINTS), dtype=torch.int64, device=self.dev)
                       if cuda else None)
        self.warm, self.graph, self.recorded, self.pool_bytes = False, None, None, 0

    def load(self, leaves, gt, lrs, opt_state, count: int) -> None:
        """Copy one call's inputs in, on the current stream (outside any
        graph): the leaves, the ground truth, the loss scales and the
        optimizer state (``None`` zeroes the moments), the schedule
        counter set to ``count``, the history row to 0, the stamps to 0."""
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(leaves[k])
            for k, b in (self.gt or {}).items():
                if b is not None:
                    b.copy_(gt[k])
            if self.lrs is not None:
                self.lrs.copy_(lrs)
            for name, moments in self.state.items():
                for k, m in moments.items():
                    if opt_state is None:
                        m.zero_()
                    else:
                        m.copy_(opt_state[name][k])
            self.sched_i.fill_(count)
            self.row_i.zero_()
            if self.stamps is not None:
                self.stamps.zero_()

    def record(self, values: Dict[Tuple[str, str], torch.Tensor]) -> None:
        """Write a step's values into the histories at the row counter;
        the first step allocates them on the stream that made the trace
        (step 0 runs on the side stream on the card)."""
        if not self.hist:
            with contextlib.nullcontext() if self.home is None else torch.cuda.stream(self.home):
                for k, v in values.items():
                    self.hist[k] = v.new_empty((self.rows,) + tuple(v.shape))
        for k, v in values.items():
            self.hist[k].index_copy_(0, self.row_i, v[None])

    def total(self, i: int) -> torch.Tensor:
        return self.hist[("step", "total")][i].clone()

    def result(self, count: int, length: int, span=None) -> RefineResult:
        """Copies of the call's params, state and history rows: a later
        call writes the buffers, never a result already returned.  A live
        ``span`` (the call's ``dd.refine``) gets a copy of the call's stamp
        rows, on the device."""
        if span and self.stamps is not None:
            span.stamps = self.stamps[:length].clone()
        hist = {key: v[:length].clone() for key, v in self.hist.items()}
        logs = {k: v for (kind, k), v in hist.items() if kind == "log"}
        state = {"count": count + length}
        state.update((name, {k: m.clone() for k, m in moments.items()})
                     for name, moments in self.state.items())
        return RefineResult(
            params={k: p.detach().clone() for k, p in self.params.items()},
            mtx_history=hist[("step", "mtx")],
            losses_values={k: v for k, v in logs.items() if not k.startswith("_")},
            total_loss=hist[("step", "total")],
            telemetry={k: v for k, v in logs.items() if k.startswith("_")} or None,
            opt_state=state,
        )


class CapturedRefine:
    """The refinement compiled once and called many times: the counterpart
    of the reference's ``jax.jit(functools.partial(refine, ...),
    static_argnames=("num_steps",))`` (``optimize.py:324, 414``,
    ``diffdope.py:562``, ``bop.py:388``).

    Built from what the partial binds (the loss: ``fused_loss_fn``, or
    ``render_fn`` with ``loss_fns`` and ``weights``; the schedule and the
    optimizer; ``loss_scale``; ``process_group``) and called as the
    reference calls its ``jit_refine``: ``(params, gt=, learning_rates=,
    opt_state=, num_steps=, extra_params=, step_callback=)``, returning
    :func:`refine`'s :class:`RefineResult`, bit for bit.

    It owns every tensor the step reads or writes, on the params' device
    (inputs held elsewhere, or as numpy, are copied there), at addresses
    fixed while the layout of the inputs stays (a ``_Trace``): the leaves,
    the optimizer's moments, the schedule tables laid out once over the
    ``horizon`` (``nb_iterations + 1`` steps) and read at a schedule
    counter on the device, which each call sets from ``opt_state``'s
    count (so a restart's reset count reads row 0 again), the histories
    written at a row counter that each call restarts at 0, the ground
    truth and the loss scales the step reads.  Each call copies its
    inputs into those buffers on the current stream, outside the graph;
    ``opt_state=None`` zeroes the moments and the count.  A call whose
    steps would run past the horizon raises.

    On the card (``cuda_graph``, no ``process_group``) the first call
    runs step 0 eagerly on a side stream, the warm-up a capture needs,
    under ``torch.cuda.set_sync_debug_mode("error")``, then captures the
    step once (``torch.cuda.CUDAGraph`` on that stream, without
    ``torch.cuda.graph``'s synchronize, ``gc.collect`` and
    ``empty_cache``) and replays it for every later step; every later
    call replays it for all its steps, step 0 included, each replay adding
    the launches its capture recorded (``kernels.add_launches``).  A step
    that waits for the host (a read of a tensor's value, a data-dependent
    shape, host data copied in) cannot be captured: the call raises,
    naming the loss and its route, and never falls back to the eager loop.
    A call whose inputs differ in shape, dtype or device from the
    trace's gets a new trace, warm-up and capture, as jit retraces; one
    trace is kept, so the old graph and its memory pool go first.  The
    graph's pool stays reserved for as long as the object lives
    (``pool_bytes``): drop the object to release it.  ``cuda_graph=False``,
    the CPU and ``process_group`` run the eager loop over the same buffers.

    The results' params, histories and state are copies: a later call
    never changes a result already returned.

    Counters, always kept: ``calls``, ``traces`` (the layouts laid out),
    ``captures`` (the graphs captured), ``replays`` (the graph replays,
    a step each), ``step0_s`` and ``capture_s`` (the host seconds of the
    eager steps 0 and of the captures), ``pool_bytes``.  While tracing is
    on (``trace``) a call records the span ``dd.refine`` (attributes
    ``steps``, ``new_trace``) with ``dd.refine.load`` (the copy-in),
    ``dd.refine.step0``, ``dd.refine.capture``, ``dd.refine.replay``
    (``replays``, and ``first_launch_end_ns``: the clock when the first
    replay was launched) and ``dd.refine.result``, and the call's stamps
    (``trace.stamp``: each step's entry, table, objective, gradients and
    end on the device's clock; a captured step writes them on every
    replay, whether tracing is on or not)."""

    def __init__(
        self,
        render_fn: Optional[Callable] = None,
        loss_fns: Sequence[Callable] = (),
        weights: Optional[Dict[str, float]] = None,
        nb_iterations: int = 60,
        base_lr: float = 20.0,
        lr_decay: float = 0.1,
        optimizer: str = "sgd",
        fused_loss_fn: Optional[Callable] = None,
        loss_scale: float = 1.0,
        process_group: Any = None,
        cuda_graph: bool = True,
        horizon: Optional[int] = None,
    ):
        if fused_loss_fn is None and render_fn is None:
            raise ValueError("refine needs fused_loss_fn or render_fn + loss_fns")
        self.render_fn, self.loss_fns, self.weights = render_fn, tuple(loss_fns), weights
        self.fused_loss_fn = fused_loss_fn
        self.nb_iterations = nb_iterations
        self.horizon = nb_iterations + 1 if horizon is None else horizon
        self.opt = make_optimizer(optimizer, base_lr, lr_decay, nb_iterations)
        self.loss_scale, self.process_group = loss_scale, process_group
        self.cuda_graph = cuda_graph
        sig = () if fused_loss_fn is None else inspect.signature(fused_loss_fn).parameters
        self._fused_takes_gt = len([p for p in sig if p != "learning_rates"]) >= 2
        self._fused_takes_lrs = "learning_rates" in sig
        self._what = _describe(fused_loss_fn, render_fn)
        self._trace: Optional[_Trace] = None
        self.calls = self.traces = self.captures = self.replays = 0
        self.step0_s = self.capture_s = 0.0

    @property
    def pool_bytes(self) -> int:
        """The bytes the kept graph's memory pool reserved at its capture
        (0 without a graph)."""
        return 0 if self._trace is None else self._trace.pool_bytes

    def __call__(
        self,
        params: Dict[str, torch.Tensor],
        gt: Optional[Dict[str, torch.Tensor]] = None,
        learning_rates: Optional[torch.Tensor] = None,
        opt_state: Any = None,
        num_steps: Optional[int] = None,
        extra_params: Optional[Dict[str, torch.Tensor]] = None,
        step_callback: Optional[Callable] = None,
    ) -> RefineResult:
        with trace.span("refine") as span:
            return self._call(span, params, gt, learning_rates, opt_state, num_steps,
                              extra_params, step_callback)

    def _call(self, span, params, gt, learning_rates, opt_state, num_steps, extra_params,
              step_callback) -> RefineResult:
        self.calls += 1
        if self.fused_loss_fn is not None and extra_params:
            raise ValueError("fused_loss_fn does not support extra_params")
        leaves = dict(params)
        leaves.update(extra_params or {})
        dev = next(iter(leaves.values())).device
        # host arrays go to the device once: no step copies host data
        if learning_rates is not None and not isinstance(learning_rates, torch.Tensor):
            learning_rates = tensor(learning_rates, dev)
        if gt is not None:
            gt = {k: v if v is None or isinstance(v, torch.Tensor) else tensor(v, dev)
                  for k, v in gt.items()}
        fused = self.fused_loss_fn is not None
        if fused and not self._fused_takes_gt:
            gt = None  # a loss with its ground truth bound reads none
        if fused and not self._fused_takes_lrs:
            learning_rates = None
        count = 0 if opt_state is None else int(opt_state["count"])
        length = self.nb_iterations + 1 if num_steps is None else num_steps
        if count + length > self.horizon:
            raise ValueError(
                f"CapturedRefine: steps {count}..{count + length - 1} (opt_state's count "
                f"{count}, num_steps {length}) run past the schedule's horizon of "
                f"{self.horizon} steps")
        key = (dev, tuple((k, _layout(v)) for k, v in leaves.items()),
               tuple(extra_params or ()),
               None if gt is None else tuple((k, _layout(v)) for k, v in gt.items()),
               _layout(learning_rates))
        new = self._trace is None or self._trace.key != key
        span.set(steps=length, new_trace=new)
        if new:
            self._trace = None  # the old graph and its pool go first
            self._trace = _Trace(key, leaves, tuple(extra_params or ()), gt,
                                 learning_rates, self.opt, self.horizon)
            self.traces += 1
        tr = self._trace
        with trace.span("refine.load"):
            tr.load(leaves, gt, learning_rates, opt_state, count)
        group = self.process_group
        # under a group every binning takes the union over the ranks' hypotheses
        with (trace.stamping(tr.stamps, tr.row_i),
              contextlib.nullcontext() if group is None else union_over(group)):
            if self.cuda_graph and tr.dev.type == "cuda" and group is None:
                self._replayed(tr, length, step_callback)
            else:
                for i in range(length):
                    self._step(tr)
                    if step_callback is not None:
                        step_callback(i, tr.total(i))
        with trace.span("refine.result"):
            return tr.result(count, length, span)

    def _objective(self, tr: _Trace, mtx: torch.Tensor):
        if self.fused_loss_fn is not None:
            kw = {} if tr.lrs is None else {"learning_rates": tr.lrs}
            return (self.fused_loss_fn(mtx, tr.gt, **kw) if self._fused_takes_gt
                    else self.fused_loss_fn(mtx, **kw))
        renders = self.render_fn(mtx, **{k: tr.params[k] for k in tr.extra_keys})
        total = mtx.new_zeros(())
        logs = {k: v for k, v in renders.items() if k.startswith("_")}
        for fn in self.loss_fns:
            term, (key, values) = fn(renders, tr.gt, tr.lrs, self.weights)
            total = total + term
            logs[key] = values
        return total, logs

    def _step(self, tr: _Trace) -> None:
        """One step, a function of the trace's device state only (the
        counterpart of the reference's ``lax.scan`` body): the pose, the
        loss, its gradients, the histories' row and the update in place;
        stamped (``trace.stamp``, inside the call's ``trace.stamping``) at
        its entry, the table (the render pipeline's ``trace.TABLE``), the
        objective, the gradients and its end."""
        trace.stamp(trace.STEP)
        row = {k: t.index_select(0, tr.sched_i).reshape(()) for k, t in tr.tables.items()}
        params = tr.params
        mtx, _, _ = pose_matrix(params)
        total, logs = self._objective(tr, mtx)
        trace.stamp(trace.OBJECTIVE)
        if self.loss_scale != 1.0:
            total = total * self.loss_scale
        # a leaf the render does not read (vertex colours under corner
        # colours) gets a zero gradient, as JAX's grad gives it
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        trace.stamp(trace.GRAD)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if self.process_group is not None:
            total, logs = _all_reduce_step(grads, tr.extra_keys, total.detach(), logs,
                                           self.process_group)
        with torch.no_grad():
            tr.record({("step", "mtx"): mtx.detach(), ("step", "total"): total.detach(),
                       **{("log", k): v.detach() for k, v in logs.items()}})
            self.opt.update(grads, tr.state, params, row)
            tr.sched_i.add_(1)
            tr.row_i.add_(1)
        trace.stamp(trace.END)

    def _replayed(self, tr: _Trace, length: int, callback: Optional[Callable]) -> None:
        """Run ``length`` steps on the card: on a new trace step 0 eagerly
        on the side stream (the warm-up a capture needs: the kernels'
        library, autograd's first run) with any host sync an error; then
        the step captured once on that stream, if it is not yet, and
        replayed on the current stream for every remaining step."""
        main = torch.cuda.current_stream(tr.dev)
        first = 0
        if not tr.warm:
            t0 = time.perf_counter()
            tr.side.wait_stream(main)
            mode = torch.cuda.get_sync_debug_mode()
            with trace.span("refine.step0"), torch.cuda.stream(tr.side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._step(tr)
                except RuntimeError as err:
                    if "synchroniz" not in str(err):
                        raise
                    raise RuntimeError(f"refine: the step of {self._what} waits for the "
                                       f"host, so it cannot be captured as a CUDA graph: "
                                       f"{err}") from err
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            main.wait_stream(tr.side)
            tr.warm, first = True, 1
            self.step0_s += time.perf_counter() - t0
            if callback is not None:
                callback(0, tr.total(0))
        if first == length:
            return
        if tr.graph is None:
            self._capture(tr)
        with trace.span("refine.replay", replays=length - first) as span:
            for i in range(first, length):
                tr.graph.replay()
                if span and i == first:
                    span.set(first_launch_end_ns=trace.clock_ns())
                kernels.add_launches(tr.recorded)
                if callback is not None:
                    callback(i, tr.total(i))
        self.replays += length - first

    def _capture(self, tr: _Trace) -> None:
        """Capture the step on the side stream, recording its launches and
        the bytes its memory pool reserved and its host seconds."""
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(tr.dev)
        graph = torch.cuda.CUDAGraph()
        try:
            with trace.span("refine.capture"), kernels.recording() as recorded, \
                    torch.cuda.stream(tr.side):
                graph.capture_begin()
                try:
                    self._step(tr)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except RuntimeError as err:
            raise RuntimeError(f"refine: the step of {self._what} cannot be captured as a "
                               f"CUDA graph: {err}") from err
        tr.graph, tr.recorded = graph, recorded
        tr.pool_bytes = torch.cuda.memory_reserved(tr.dev) - reserved
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


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
    jit_refine: Optional[Callable] = None,
    **refine_kwargs,
) -> RefineResult:
    """:func:`refine` in segments of ``segment_steps`` steps, the optimizer
    state, the schedule's step count and the ``extra_params`` leaves
    carried across, so the result is the unsegmented run's.  Every
    segment calls ``jit_refine`` (a :class:`CapturedRefine`, or anything
    called as one), by default one built here from the loss and
    ``refine_kwargs``, so the run pays one step 0 and one capture
    (``optimize.py:324, 344-355``); a given ``jit_refine`` ignores
    ``refine_kwargs`` but ``step_callback``, as the reference's does.
    ``progress_fn(done_steps, total_steps, last_total_loss)`` is called
    after every segment (the one host sync of a segment, which also times
    it: ``segment_times``)."""
    step_callback = refine_kwargs.pop("step_callback", None)
    if jit_refine is None:
        jit_refine = CapturedRefine(render_fn, loss_fns, weights, nb_iterations,
                                    **refine_kwargs)
    total = nb_iterations + 1
    params, extra, opt_state = params0, extra_params, None
    parts, segment_times = [], []
    done = 0
    while done < total:
        n = min(segment_steps, total - done)
        t0 = time.perf_counter()
        res = jit_refine(params, gt=gt, learning_rates=learning_rates, opt_state=opt_state,
                         num_steps=n, extra_params=extra, step_callback=step_callback)
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
    jit_refine: Optional[Callable] = None,
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
    carried across them.  Every chunk calls ``jit_refine``, as in
    :func:`refine_segmented` (``optimize.py:414, 443-455``; one
    :class:`CapturedRefine` built here by default: one step 0 and one
    capture for the run).
    ``draw_jitter`` defaults to
    :func:`draw_pose_jitter` from a generator seeded 0.  Histories, logs
    and telemetry are the segments' concatenated."""
    step_callback = refine_kwargs.pop("step_callback", None)
    if jit_refine is None:
        jit_refine = CapturedRefine(render_fn, loss_fns, weights, nb_iterations,
                                    **refine_kwargs)
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
            res = jit_refine(params, gt=gt, learning_rates=learning_rates,
                             opt_state=opt_state, num_steps=m, step_callback=step_callback)
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
