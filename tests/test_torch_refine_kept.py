"""The compiled refinement kept across calls (``optimize.CapturedRefine``),
the counterpart of the reference's ``jit_refine``: one
``jax.jit(functools.partial(refine, ...))`` called by every segment,
restart chunk, bench run and sweep object.

(a) One object called three times, with other poses, ground truth, loss
scales and optimizer state each call (a continued count, then a restart's
reset), equals three fresh ``refine`` calls bit for bit, on the fused
loss with its ground truth given per call and on ``render_fn`` +
``loss_fns``, with Adam and SGD; (b) a result held from the first call is
unchanged by the later ones.  (c) ``refine_segmented`` and
``refine_with_restarts`` equal each other's runs bit for bit with
``jit_refine`` left None, given, and a fresh ``refine`` a call (the loop
before the object was kept); and one object serving two segmented and two
restarted runs agrees with the JAX package's, run twice each through one
jitted ``jit_refine``, at the contract's tolerances (loss sums rtol 1e-5
/ atol 1e-7, poses rtol 2e-4 / atol 1e-6).  (d) A call with another batch
lays out a new trace (on the card a new capture), never the old one's,
and a count past the schedule's horizon raises.

The icosphere(2) scene at 64x96, B=3 (``tests/test_torch_refine_capture.py``
and ``tests/torch_scene.py``), on the CPU, where the object runs the eager
loop over its kept buffers; the card's graph replays are held in
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

from torch_scene import LRS, WEIGHTS, jax_fused_loss, jax_jitter_draws, jax_scene, port_fused_loss

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.bench import distinct_poses
from diffdope_tpu_torch.optimize import (
    CapturedRefine,
    draw_pose_jitter,
    refine,
    refine_segmented,
    refine_with_restarts,
)
from torch_scene import one_torch_thread  # noqa: F401

import test_torch_refine_capture as capture

NB = 5  # six steps: a horizon of 6 schedule rows
SGD = dict(base_lr=0.5, lr_decay=0.1, optimizer="sgd")
OPTIMIZERS = {"adam": dict(base_lr=0.02, optimizer="adam"),
              "sgd": dict(base_lr=1.0, optimizer="sgd")}
DEG, TRANS = 10.0, 0.02


def _same(a, b) -> None:
    """Two RefineResults equal bit for bit: poses, totals, logs,
    telemetry, params and the optimizer state."""
    assert torch.equal(a.mtx_history, b.mtx_history)
    assert torch.equal(a.total_loss, b.total_loss)
    for group in ("losses_values", "telemetry", "params"):
        x, y = getattr(a, group) or {}, getattr(b, group) or {}
        assert set(x) == set(y), group
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), (group, k)
    sa, sb = a.opt_state or {}, b.opt_state or {}
    assert set(sa) == set(sb)
    for name in sa:
        if name == "count":
            assert sa[name] == sb[name]
        else:
            for k in sa[name]:
                assert torch.equal(sa[name][k], sb[name][k]), (name, k)


def _snapshot(res):
    """A deep copy of a RefineResult's tensors."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        return v
    return type(res)(*(copy(v) for v in res))


def _calls(params0, kw):
    """Three calls' inputs: other poses, ground truth and loss scales each,
    the second continuing the first's count, the third from a reset
    state, a step longer."""
    gt0 = {k: torch.as_tensor(np.asarray(v)) for k, v in kw["gt"].items() if v is not None}
    gts = [gt0, {k: torch.roll(v, 3, dims=1) for k, v in gt0.items()},
           {k: torch.flip(v, dims=[0]) for k, v in gt0.items()}]
    lrs = torch.as_tensor(np.asarray(kw["learning_rates"]))
    poses = [params0, distinct_poses(params0, 0.01), distinct_poses(params0, -0.02)]
    return [dict(params=p, gt=g, learning_rates=lrs * s, num_steps=n)
            for p, g, s, n in zip(poses, gts, (1.0, 1.5, 0.5), (2, 2, 3))]


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("route", ["bop", "unfused"])
def test_torch_kept_calls_equal_fresh_refines(route, optimizer, monkeypatch):
    params0, kw = capture.ROUTES[route](monkeypatch)
    loss = {k: kw[k] for k in ("fused_loss_fn", "render_fn", "loss_fns", "weights")
            if k in kw}
    settings = dict(nb_iterations=NB, **OPTIMIZERS[optimizer], **loss)
    jit_refine = CapturedRefine(**settings)
    kept, fresh = [], []
    held = None
    for i, call in enumerate(_calls(params0, kw)):
        opt_state = kept[0].opt_state if i == 1 else None
        got = jit_refine(call["params"], gt=call["gt"], learning_rates=call["learning_rates"],
                         opt_state=opt_state, num_steps=call["num_steps"])
        want = refine(call["params"], gt=call["gt"], learning_rates=call["learning_rates"],
                      opt_state=None if i != 1 else fresh[0].opt_state,
                      num_steps=call["num_steps"], **settings)
        kept.append(got)
        fresh.append(want)
        if i == 0:
            held = _snapshot(got)
    for got, want in zip(kept, fresh):
        _same(got, want)
    assert [r.opt_state["count"] for r in kept] == [2, 4, 3]
    # the calls differ, so equal results prove nothing stale was read
    assert not torch.equal(kept[0].total_loss, kept[2].total_loss[:2])
    assert jit_refine.traces == 1 and jit_refine.captures == 0  # no graph on the CPU
    # (b) the first call's result, held, is unchanged by the later calls
    _same(kept[0], held)


def _fused_bench():
    from diffdope_tpu_torch.bench import bench_problem

    pb = bench_problem(capture.RES, subdiv=2, batch=capture.B, device="cpu")
    return pb["params0"], pb["fn"]


@pytest.mark.parametrize("runner", ["segmented", "restarts"])
def test_torch_segments_and_restarts_share_one_kept_refine(runner):
    """Adam on the bench loss, six steps: in segments of 4 (4 + 2, the
    second continuing the count) or with a restart and chunks of 2 (2 + 1
    per segment, the moments reset between): ``jit_refine`` None, one
    object given, and a fresh ``refine`` a chunk give the same bits."""
    params0, fn = _fused_bench()
    settings = dict(nb_iterations=NB, base_lr=0.02, lr_decay=0.1, optimizer="adam")
    if runner == "segmented":
        def run(**kw):
            return refine_segmented(params0, fused_loss_fn=fn, segment_steps=4, **settings,
                                    **kw)
    else:
        def run(**kw):
            gen = torch.Generator().manual_seed(5)
            return refine_with_restarts(
                params0, fused_loss_fn=fn, restarts=1, restart_jitter_deg=DEG,
                restart_jitter_trans=TRANS, segment_steps=2,
                draw_jitter=lambda b: draw_pose_jitter(b, gen, DEG, TRANS), **settings, **kw)
    jit_refine = CapturedRefine(fused_loss_fn=fn, **settings)
    per_call = functools.partial(refine, fused_loss_fn=fn, **settings)
    default, kept, fresh = run(), run(jit_refine=jit_refine), run(jit_refine=per_call)
    for got in (kept, fresh):
        assert got.total_loss.shape == (NB + 1,)
        for k in default.losses_values:
            assert torch.equal(got.losses_values[k], default.losses_values[k]), k
        assert torch.equal(got.mtx_history, default.mtx_history)
        assert torch.equal(got.total_loss, default.total_loss)
        for k in default.params:
            assert torch.equal(got.params[k], default.params[k]), k
    assert jit_refine.traces == 1


@pytest.fixture(scope="module")
def jax_jit_refine():
    """The reference's ``jit_refine`` of the scene's fused loss (SGD, six
    steps), shared by its two segmented and two restarted runs: one
    compile, of 3-step calls."""
    import jax

    from diffdope_tpu.optimize import refine as j_refine

    mp = pytest.MonkeyPatch()
    fn = jax_fused_loss(mp)
    yield jax.jit(functools.partial(
        j_refine, render_fn=None, loss_fns=(), weights=WEIGHTS, nb_iterations=NB,
        fused_loss_fn=fn, **SGD), static_argnames=("num_steps",))
    mp.undo()


def test_torch_kept_refine_matches_reference_jit_refine(jax_jit_refine):
    """Two segmented runs (segments of 3) and two runs with one restart,
    each from other initial poses (and each restart from its own key),
    through one jitted ``jit_refine`` in the reference and one
    ``CapturedRefine`` in the port: each run's logged terms and totals at
    rtol 1e-5 / atol 1e-7, its poses at rtol 2e-4 / atol 1e-6."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.optimize import refine_segmented as j_segmented
    from diffdope_tpu.optimize import refine_with_restarts as j_restarts

    sc = jax_scene()
    starts = [sc["params0"], {k: v + np.float32(0.004) * np.arange(3, dtype=np.float32)
                              for k, v in sc["params0"].items()}]
    jit_refine = CapturedRefine(fused_loss_fn=port_fused_loss(), nb_iterations=NB, **SGD)
    runs = []
    for p0 in starts:
        want = j_segmented({k: jnp.asarray(v) for k, v in p0.items()}, None, (), sc["gt"],
                           jnp.asarray(LRS), WEIGHTS, nb_iterations=NB, segment_steps=3,
                           jit_refine=jax_jit_refine)
        got = refine_segmented(convert.state(p0, "cpu"), nb_iterations=NB, segment_steps=3,
                               jit_refine=jit_refine)
        runs.append((got, want))
    for p0, seed in zip(starts, (3, 4)):
        key = jax.random.PRNGKey(seed)
        want = j_restarts({k: jnp.asarray(v) for k, v in p0.items()}, None, (), sc["gt"],
                          jnp.asarray(LRS), WEIGHTS, nb_iterations=NB, restarts=1,
                          restart_jitter_deg=DEG, restart_jitter_trans=TRANS, key=key,
                          jit_refine=jax_jit_refine)
        _, sub = jax.random.split(key)
        feed = iter([jax_jitter_draws(sub, 3, DEG, TRANS)])
        got = refine_with_restarts(convert.state(p0, "cpu"), nb_iterations=NB, restarts=1,
                                   restart_jitter_deg=DEG, restart_jitter_trans=TRANS,
                                   draw_jitter=lambda b: next(feed), jit_refine=jit_refine)
        assert next(feed, None) is None
        runs.append((got, want))
    assert jit_refine.traces == 1
    for got, want in runs:
        assert got.mtx_history.shape == (NB + 1, 3, 4, 4)
        for name, v in want.losses_values.items():
            np.testing.assert_allclose(got.losses_values[name].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got.total_loss.numpy(), np.asarray(want.total_loss),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.mtx_history.numpy(), np.asarray(want.mtx_history),
                                   rtol=2e-4, atol=1e-6)
    # the second start is not the first: the runs are not one run repeated
    assert not np.allclose(runs[0][0].mtx_history.numpy(), runs[1][0].mtx_history.numpy())


def test_torch_other_batch_retraces_and_horizon_raises(monkeypatch):
    """B=3, then B=2, then B=3 again: each change of layout is a new trace
    (never the old one's buffers), each result a fresh ``refine``'s bit
    for bit; steps past the horizon raise by name, before any step."""
    params0, kw = capture.ROUTES["bop"](monkeypatch)
    settings = dict(nb_iterations=NB, fused_loss_fn=kw["fused_loss_fn"], **OPTIMIZERS["adam"])
    lrs = torch.as_tensor(np.asarray(kw["learning_rates"]))
    jit_refine = CapturedRefine(**settings)
    for i, b in enumerate((3, 2, 3)):
        p = {k: v[:b] for k, v in distinct_poses(params0, 0.01 * (i + 1)).items()}
        got = jit_refine(p, gt=kw["gt"], learning_rates=lrs[:b], num_steps=2)
        want = refine(p, gt=kw["gt"], learning_rates=lrs[:b], num_steps=2, **settings)
        _same(got, want)
        assert got.mtx_history.shape == (2, b, 4, 4)
        assert jit_refine.traces == i + 1
    with pytest.raises(ValueError, match="horizon"):
        jit_refine(params0, gt=kw["gt"], learning_rates=lrs, num_steps=2,
                   opt_state=dict(got.opt_state, count=NB))
    assert jit_refine.traces == 3
