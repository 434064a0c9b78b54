"""The refinement options of ``run_optimization`` in the port against the
reference: the init / restart pose jitter (``optimize.jitter_pose_params``),
basin-hopping restarts (``optimize.refine_with_restarts``), precomputed
bins (``render/pipeline.precompute_bins``) and the per-step live loss.

Torch's RNG cannot reproduce ``jax.random``, so the jitter's draws are
inputs: the test draws them with ``jax.random`` under the reference's own
key splits and hands them to the port's deterministic apply.  Restarts
run the fused loss of the shared test scene (``tests/torch_scene.py``,
SGD, f32 d_rows) in both packages; each step's logged terms must agree at
rtol 1e-5 and the re-seed's argmin must be the same.  Precomputed bins
(margin 24 px) must give the ids of per-step binning in both packages
(the slots a margin adds never win a pixel: every raster tests a (pixel,
slot) pair by the slot's own planes), the same fused loss (rtol 1e-5) and
pose gradients within the contract (rtol 2e-4, atol 1e-6).
"""

import functools

import numpy as np
import pytest
import torch

from torch_scene import (
    LRS,
    MAX_K,
    RES,
    WEIGHTS,
    jax_fused_loss,
    jax_jitter_draws,
    jax_scene,
    port_fused_loss,
)

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import apply_pose_jitter, pose_matrix, refine_with_restarts
from torch_scene import one_torch_thread  # noqa: F401

STEPS = 6
SGD = dict(base_lr=0.5, lr_decay=0.1, optimizer="sgd")
DEG, TRANS = 10.0, 0.02


@pytest.mark.parametrize("deg,trans", [(5.0, 0.0), (0.0, 0.01), (10.0, 0.02)])
def test_torch_jitter_apply_matches_reference(deg, trans):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.optimize import jitter_pose_params

    params = jax_scene()["params0"]
    key = jax.random.PRNGKey(7)
    want = jitter_pose_params({k: jnp.asarray(v) for k, v in params.items()}, key,
                              deg, trans)
    got = apply_pose_jitter(convert.state(params, "cpu"), jax_jitter_draws(key, 3, deg, trans))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        # hypothesis 0 keeps the unjittered pose
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(v)[0], rtol=0, atol=1e-7)
    assert not np.allclose(got["qx"].numpy()[1:], params["qx"][1:]) or deg == 0.0


@pytest.fixture(scope="module")
def jax_refine():
    """The reference's jitted refine of the scene's fused loss, shared by
    the restart runs (one compile per segment length)."""
    import jax

    from diffdope_tpu.optimize import refine

    mp = pytest.MonkeyPatch()
    fn = jax_fused_loss(mp)
    yield jax.jit(functools.partial(
        refine, render_fn=None, loss_fns=(), weights=WEIGHTS, nb_iterations=STEPS - 1,
        fused_loss_fn=fn, **SGD), static_argnames=("num_steps",))
    mp.undo()


@pytest.mark.parametrize("restarts,segment", [(1, 2), (2, 1)])
def test_torch_restarts_match_reference(jax_refine, restarts, segment):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.optimize import refine_with_restarts as j_restarts

    sc = jax_scene()
    key = jax.random.PRNGKey(3)
    want = j_restarts(
        {k: jnp.asarray(v) for k, v in sc["params0"].items()}, None, (), sc["gt"],
        jnp.asarray(LRS), WEIGHTS, nb_iterations=STEPS - 1, restarts=restarts,
        restart_jitter_deg=DEG, restart_jitter_trans=TRANS, key=key,
        jit_refine=jax_refine, segment_steps=segment)
    draws, k = [], key
    for _ in range(restarts):
        k, sub = jax.random.split(k)
        draws.append(jax_jitter_draws(sub, 3, DEG, TRANS))
    feed = iter(draws)
    got = refine_with_restarts(
        convert.state(sc["params0"], "cpu"), fused_loss_fn=port_fused_loss(),
        nb_iterations=STEPS - 1, restarts=restarts, restart_jitter_deg=DEG,
        restart_jitter_trans=TRANS, draw_jitter=lambda b: next(feed),
        segment_steps=segment, **SGD)
    assert next(feed, None) is None  # one draw a re-seed
    assert got.mtx_history.shape == (STEPS, 3, 4, 4)
    for name, v in want.losses_values.items():
        np.testing.assert_allclose(got.losses_values[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    # the poses at the trajectory tolerance of tests/test_torch_refine.py
    np.testing.assert_allclose(got.mtx_history.numpy(), np.asarray(want.mtx_history),
                               rtol=1e-4, atol=1e-5)
    # each re-seed: the same winner; the others jittered off hypothesis 0
    n_seg, done = restarts + 1, 0
    for seg in range(restarts):
        done += (STEPS - done) // (n_seg - seg)
        mean = sum(np.asarray(v) for v in want.losses_values.values())[done - 1]
        best = int(np.argmin(mean))
        got_mean = sum(v.numpy() for v in got.losses_values.values())[done - 1]
        assert int(np.argmin(got_mean)) == best
        assert not torch.allclose(got.mtx_history[done, 1], got.mtx_history[done, 0])


def _bins_render(package, bins, layout="channels"):
    sc = jax_scene()
    if package == "port":
        from diffdope_tpu_torch.render.pipeline import render_batch

        st = convert.state(sc, "cpu")
        return render_batch(st["proj"], st["mtx0"], st["pos"], st["tri"], RES,
                            vtx_color=st["vtx_color"], edge_adj=st["edge_adj"],
                            layout=layout, max_tris_per_tile=MAX_K, raster_impl="pallas",
                            device="cpu", bins=bins)
    import jax

    from diffdope_tpu.render.pipeline import render_batch

    return jax.jit(lambda m: render_batch(
        sc["proj"], m, sc["pos"], sc["tri"], RES, vtx_color=sc["vtx_color"],
        edge_adj=sc["edge_adj"], layout=layout, max_tris_per_tile=MAX_K,
        raster_impl="pallas", bins=bins))(sc["mtx0"])


def _port_bins(margin=24.0, k="auto"):
    from diffdope_tpu_torch.render.pipeline import precompute_bins

    st = convert.state(jax_scene(), "cpu")
    return precompute_bins(st["proj"], st["mtx0"], st["pos"], st["tri"], RES, k, margin,
                           device="cpu")


def test_torch_precomputed_bins_win_no_pixel():
    """The extra slots a 24 px margin adds never win a pixel, in either
    package: the render's ids over precomputed bins are per-step binning's."""
    from diffdope_tpu.render.pipeline import precompute_bins as j_precompute

    bins = _port_bins()
    per_step = _bins_render("port", None)
    over = _bins_render("port", bins)
    np.testing.assert_array_equal(over["ids"].numpy(), per_step["ids"].numpy())
    for key in ("mask", "depth"):
        np.testing.assert_array_equal(over[key].numpy(), per_step[key].numpy(), err_msg=key)
    assert "_bin_overflow" not in over  # the uniform table: nothing binned per call
    # the margin widened the bins: more (tile, triangle) pairs than a step's
    wide, tight = int(bins.counts.sum()), int(_port_bins(margin=0.0).counts.sum())
    assert wide > 2 * tight
    sc = jax_scene()
    j_bins = j_precompute(sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES,
                          max_tris_per_tile=MAX_K, margin_px=24.0)
    j_over, j_step = _bins_render("jax", j_bins), _bins_render("jax", None)
    np.testing.assert_array_equal(np.asarray(j_over["ids"]), np.asarray(j_step["ids"]))
    assert int(np.asarray(j_bins[1]).sum()) > int(np.asarray(
        j_precompute(sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES,
                     max_tris_per_tile=MAX_K, margin_px=0.0)[1]).sum())


def test_torch_precomputed_bins_fused_loss():
    """make_fused_loss(bins=) at the init: the loss of per-step binning
    (rtol 1e-5) and its pose gradients (rtol 2e-4, atol 1e-6), on the
    compact table with its crop, sized to the bins."""
    from diffdope_tpu_torch.render.pipeline import K_CHUNK, make_fused_loss

    sc = convert.state(jax_scene(), "cpu")
    bins = _port_bins()
    need = int((-(-bins.counts // K_CHUNK) * K_CHUNK).sum())
    fn_bins = make_fused_loss(
        sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS, use_rgb=True,
        use_mask=True, edge_adj=sc["edge_adj"], vtx_color=sc["vtx_color"],
        compact_total=need, device="cpu", bins=bins)
    fn_step = port_fused_loss()

    def grads(fn):
        p = {k: v.clone().requires_grad_(True) for k, v in sc["params0"].items()}
        total, logs = fn(pose_matrix(p)[0])
        grads = torch.autograd.grad(total, list(p.values()))
        return float(total.detach()), {k: v.detach() for k, v in logs.items()}, grads

    t_b, logs_b, g_b = grads(fn_bins)
    t_s, logs_s, g_s = grads(fn_step)
    assert int(logs_b["_bin_overflow"]) == 0 and int(logs_s["_bin_overflow"]) == 0
    np.testing.assert_allclose(t_b, t_s, rtol=1e-5)
    for key in ("rgb", "mask_selection"):
        np.testing.assert_allclose(logs_b[key].numpy(), logs_s[key].numpy(), rtol=1e-5)
    for a, b in zip(g_b, g_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_torch_precomputed_bins_overflow_raises():
    with pytest.raises(ValueError, match="bin overflow"):
        _port_bins(k=4)
    bins = _port_bins()
    assert bins.idx.shape[1] % 128 == 0 and bins.idx.shape[1] >= int(bins.counts.max())
    # every triangle's every occurrence is held by the inverted map
    assert int(bins.inv_valid.sum()) == int(bins.counts.sum())


RES_DD = (48, 64)


def _port_session(nb_iterations=5, **tpu):
    """A port DiffDope on the CPU: icosphere(2), its gt the port's render
    at a pose the init is a few degrees off."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import mesh_from_arrays
    from diffdope_tpu_torch.optimize import pose_params
    from diffdope_tpu_torch.render.pipeline import render_rgb_mask
    from diffdope_tpu_torch.testing import icosphere

    v, f = icosphere(2)
    mesh = mesh_from_arrays(v * 0.4, f, colors=v * 0.5 + 0.5)
    h, w = RES_DD
    camera = tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    mtx_gt = pose_matrix(pose_params([0, 0, 0, 1.0], [0.05, 0.0, -3.0], 1, "cpu"))[0]
    gt = render_rgb_mask(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, RES_DD,
                         edge_adj=mesh.edge_adj, vtx_color=mesh.vtx_color, device="cpu")
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gt["rgb"][0].numpy()),
                      tensor_segmentation=tdd.Image(img_tensor=gt["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=3, mesh=mesh)
    cfg = {"losses": {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True,
                      "weight_rgb": 0.7},
           "hyperparameters": {"batchsize": 3, "nb_iterations": nb_iterations,
                               "base_lr": 20.0, "lr_decay": 0.1,
                               "learning_rates_bound": [0.5, 2.0]},
           "tpu": dict({"seed": 1, "raster_impl": "pallas", "progress": False}, **tpu)}
    return tdd.DiffDope(cfg=tdd.ConfigNode(cfg), camera=camera, object3d=obj, scene=scene,
                        device="cpu")


def test_torch_live_loss_step_logs_every_step(caplog):
    dd = _port_session(live_loss="step")
    with caplog.at_level("INFO", logger="diffdope_tpu_torch.diffdope"):
        dd.run_optimization()
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("step ")]
    assert len(lines) == dd.nb_iterations + 1
    assert lines[0].startswith("step 1/6 loss ") and lines[-1].startswith("step 6/6 loss ")
    total = dd._result.total_loss.numpy()
    # the "%.5f" of each line
    assert [float(x.rsplit(" ", 1)[1]) for x in lines] == pytest.approx(total, abs=5e-6)


def test_torch_diffdope_restarts_jitter_precomputed_bins(monkeypatch):
    """restarts: 1 with init jitter and precomputed bins runs on the CPU:
    as many steps as the plain run, hypothesis 0 at the unjittered init,
    the others jittered, no per-step binning inside the refinement, and
    no pair the final poses need outside the bins."""
    from diffdope_tpu_torch import optimize
    from diffdope_tpu_torch.render import pipeline

    plain = _port_session()
    plain.run_optimization()
    calls = {"refine": 0, "binned": 0, "refines": 0}
    bin_fn, refine_fn = pipeline.bin_triangles_planar, optimize.CapturedRefine.__call__

    def counted_bins(*args, **kwargs):
        calls["binned"] += calls["refine"]
        return bin_fn(*args, **kwargs)

    def counted_refine(*args, **kwargs):
        calls["refine"] = 1
        calls["refines"] += 1
        try:
            return refine_fn(*args, **kwargs)
        finally:
            calls["refine"] = 0

    monkeypatch.setattr(pipeline, "bin_triangles_planar", counted_bins)
    # every segment and restart chunk is a call of the dispatch's captured
    # refinement
    monkeypatch.setattr(optimize.CapturedRefine, "__call__", counted_refine)
    dd = _port_session(restarts=1, init_jitter_deg=5.0, init_jitter_trans=0.005,
                       precompute_bins=True, live_loss="step")
    dd.run_optimization()
    assert dd.last_run_stats["steps"] == plain.last_run_stats["steps"] == 6
    assert dd.mtx_history.shape == plain.mtx_history.shape
    np.testing.assert_array_equal(dd.mtx_history[0, 0], plain.mtx_history[0, 0])
    assert not np.allclose(dd.mtx_history[0, 1:], plain.mtx_history[0, 1:])
    assert calls["binned"] == 0 and calls["refines"] >= 2
    assert dd._bins_escaped == 0
    assert dd.last_run_stats["recovery_reruns"] == 0
    # the same draws again: a second session repeats the run
    again = _port_session(restarts=1, init_jitter_deg=5.0, init_jitter_trans=0.005,
                          precompute_bins=True)
    again.run_optimization()
    np.testing.assert_array_equal(again.mtx_history, dd.mtx_history)
