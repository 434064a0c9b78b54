"""What the BOP path needs besides ``bop.py``, held to the JAX package:
the five metrics (``adds_metric`` in torch at rtol 1e-6, the four numpy
ones exactly, with the reference's seeds and strides), ``save_ply`` byte
for byte, and the fused loss with its ground truth given per call
(``make_fused_loss(gt=None)`` -> ``fn(mtx, gt)``): step-0 sums and pose
gradients against the JAX package's deferred closure at the contract
(sums rtol 1e-5, atol 1e-7; gradients rtol 2e-4, atol 1e-6 with
DD_DROWS_BF16=0), and bit for bit the port's baked closure built with
``roi_crop="off"``, for two ground truths in turn (no kernel wrapper keeps
a plane from an earlier call), through ``optimize.refine`` too."""

import numpy as np
import pytest
import torch

from torch_scene import B, LRS, MAX_K, RES, WEIGHTS, jax_scene

from diffdope_tpu_torch import convert
from diffdope_tpu_torch import metrics as tm
from diffdope_tpu_torch.optimize import pose_matrix
from torch_scene import one_torch_thread  # noqa: F401


def _poses(seed, n):
    """n rotations and translations from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    r = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 axis=-1).reshape(n, 3, 3)
    return r.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_points,max_points", [(700, 2000), (2600, 2000), (300, None),
                                                 (500, 120)])
def test_torch_adds_metric_matches_reference(n_points, max_points):
    import jax.numpy as jnp

    from diffdope_tpu import metrics as jm

    pts = np.random.default_rng(n_points).normal(size=(n_points, 3)).astype(np.float32)
    r, t = _poses(n_points, 6)
    want = np.asarray(jm.adds_metric(jnp.asarray(pts), jnp.asarray(r[:3]),
                                     jnp.asarray(t[:3]), jnp.asarray(r[3:]),
                                     jnp.asarray(t[3:]), max_points=max_points))
    got = tm.adds_metric(pts, torch.tensor(r[:3]), torch.tensor(t[:3]), torch.tensor(r[3:]),
                         torch.tensor(t[3:]), max_points=max_points).numpy()
    assert want.shape == got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_torch_numpy_metrics_equal_reference():
    from diffdope_tpu import metrics as jm

    rng = np.random.default_rng(7)
    for n in (50, 2048, 3000):  # below, at and past the diameter's sample
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        assert tm.object_diameter(pts) == jm.object_diameter(pts)
        assert tm.object_diameter(pts, sample=100, seed=3) == jm.object_diameter(
            pts, sample=100, seed=3)
        for target in (1000, 64):
            np.testing.assert_array_equal(tm.subsample_points(pts, target),
                                          jm.subsample_points(pts, target))
    adds = rng.uniform(0.0, 0.2, size=37)
    for thr in (0.1, 0.05):
        assert tm.add_auc(adds, thr) == jm.add_auc(adds, thr)
    assert tm.add_auc([], 0.1) == jm.add_auc([], 0.1) == 0.0
    r, _ = _poses(11, 4)
    for a, b in ((r[0], r[1]), (r[2], r[2]), (r[3], -r[3])):
        assert tm.rotation_angle_deg(a, b) == jm.rotation_angle_deg(a, b)


@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (True, True)])
def test_torch_save_ply_bytes_equal_reference(tmp_path, colors, normals):
    from diffdope_tpu.mesh import save_ply as j_save_ply

    from diffdope_tpu_torch.mesh import load_mesh, save_ply
    from diffdope_tpu_torch.testing import icosphere

    v, f = icosphere(1)
    kw = {}
    if colors:
        kw["colors"] = np.concatenate([v[:, :2] * 0.7 + 0.5, v[:, 2:] * 0.6 + 0.55], 1)
    if normals:
        kw["normals"] = -v
    save_ply(tmp_path / "port.ply", v * 40.0, f, **kw)
    j_save_ply(tmp_path / "ref.ply", v * 40.0, f, **kw)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    mesh = load_mesh(tmp_path / "port.ply")
    np.testing.assert_allclose(mesh.pos[: mesh.num_vertices], v * 40.0, atol=1e-5)


# ---- the fused loss with its ground truth given per call ------------------

COMPACT = 2048


def _second_gt(gt):
    """Another ground truth on the same frame: the scene's shifted."""
    return {k: np.ascontiguousarray(np.roll(v, (3, -5), axis=(0, 1))) for k, v in gt.items()}


def _no_pallas_pack(*args, **kwargs):
    raise AssertionError("the reference packs in XLA here (DD_PACK=xla)")


@pytest.fixture(scope="module", params=[False, True], ids=["rgb_mask", "depth"])
def reference(request):
    """The JAX deferred closure's step-0 total, logs and pose gradients at
    the scene's initial poses (compact table, XLA pack, f32 d_rows), for
    the scene's ground truth and a second one, each passed per call."""
    import jax

    from diffdope_tpu.optimize import pose_matrix as j_pose_matrix
    from diffdope_tpu.render import pack_kernel
    from diffdope_tpu.render.pipeline import make_fused_loss

    use_depth = request.param
    sc = jax_scene()
    params = {k: jax.numpy.asarray(v) for k, v in sc["params0"].items()}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_DROWS_BF16", "0")
        mp.setenv("DD_PACK", "xla")
        mp.setattr(pack_kernel, "pack_binned_auto", _no_pallas_pack)
        fn = make_fused_loss(
            sc["proj"], sc["pos"], sc["tri"], RES, None, LRS, WEIGHTS, use_rgb=True,
            use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
            vtx_color=sc["vtx_color"], max_tris_per_tile=MAX_K, compact_total=COMPACT)

        def loss(p, gt):
            return fn(j_pose_matrix(p)[0], gt)

        step = jax.jit(jax.value_and_grad(loss, has_aux=True))
        for name, gt in (("a", sc["gt"]), ("b", _second_gt(sc["gt"]))):
            (total, logs), grads = step(params, gt)
            out[name] = dict(total=np.asarray(total),
                             logs={k: np.asarray(v) for k, v in logs.items()},
                             grads={k: np.asarray(v) for k, v in grads.items()}, gt=gt)
    out["use_depth"] = use_depth
    return out


def _port_loss(gt, use_depth, roi_crop="auto"):
    from diffdope_tpu_torch.bench import drows_env
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    sc = convert.state(jax_scene(), "cpu")
    with drows_env(False):
        return make_fused_loss(
            sc["proj"], sc["pos"], sc["tri"], RES, gt, LRS, WEIGHTS, use_rgb=True,
            use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
            vtx_color=sc["vtx_color"], compact_total=COMPACT, roi_crop=roi_crop,
            device="cpu")


def _value_and_grad(fn, *gt):
    params = convert.state(jax_scene()["params0"], "cpu")
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    total, logs = fn(pose_matrix(params)[0], *gt)
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), {k: v.detach() for k, v in logs.items()}, dict(zip(params, grads))


def test_torch_per_call_gt_matches_reference(reference):
    use_depth = reference["use_depth"]
    fn = _port_loss(None, use_depth)
    assert fn.crop is None and fn.gt6 is None
    terms = ("rgb", "mask_selection") + (("depth",) if use_depth else ())
    for name in ("a", "b", "a"):
        ref = reference[name]
        gt = {k: torch.tensor(v) for k, v in ref["gt"].items()}
        total, logs, grads = _value_and_grad(fn, gt)
        np.testing.assert_allclose(total.numpy(), ref["total"], rtol=1e-5, atol=1e-7)
        for k in terms:
            np.testing.assert_allclose(logs[k].numpy(), ref["logs"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert int(logs["_bin_overflow"]) == 0 == int(ref["logs"]["_bin_overflow"])
        assert "_crop_leak" not in logs and "_crop_leak" not in ref["logs"]
        for k, g in ref["grads"].items():
            assert np.abs(g).max() > 0, k
            np.testing.assert_allclose(grads[k].numpy(), g, rtol=2e-4, atol=1e-6,
                                       err_msg=f"grad {k} ({name})")


def test_torch_per_call_gt_equals_baked_without_crop(reference):
    """Per call, each gt in turn, the sums, logs and gradients equal a
    baked closure's with no crop, bit for bit."""
    use_depth = reference["use_depth"]
    deferred = _port_loss(None, use_depth)
    for name in ("a", "b", "a"):
        gt = reference[name]["gt"]
        baked = _port_loss(gt, use_depth, roi_crop="off")
        assert baked.crop is None
        t_d, logs_d, g_d = _value_and_grad(deferred, gt)
        t_b, logs_b, g_b = _value_and_grad(baked)
        assert torch.equal(t_d, t_b), name
        assert set(logs_d) == set(logs_b)
        for k in logs_b:
            assert torch.equal(logs_d[k], logs_b[k]), (name, k)
        for k in g_b:
            assert torch.equal(g_d[k], g_b[k]), (name, k)
        bound = deferred.bind_gt(gt)
        assert torch.equal(bound.gt6, baked.gt6) and bound.frame_hw == baked.frame_hw
        mtx = torch.tensor(jax_scene()["mtx0"])
        assert torch.equal(bound.dplane(mtx) if use_depth else torch.zeros(()),
                           baked.dplane(mtx) if use_depth else torch.zeros(()))


def test_torch_refine_feeds_gt_to_a_per_call_loss(reference):
    """``optimize.refine`` passes its gt to a loss that takes one: three
    Adam steps over the deferred loss equal the baked closure's bit for
    bit."""
    from diffdope_tpu_torch.optimize import refine

    use_depth = reference["use_depth"]
    gt = reference["b"]["gt"]
    params0 = convert.state(jax_scene()["params0"], "cpu")
    kw = dict(nb_iterations=2, base_lr=0.02, optimizer="adam")
    got = refine(params0, gt=gt, fused_loss_fn=_port_loss(None, use_depth), **kw)
    want = refine(params0, fused_loss_fn=_port_loss(gt, use_depth, roi_crop="off"), **kw)
    assert got.total_loss.shape == (3,)
    assert torch.equal(got.total_loss, want.total_loss)
    assert torch.equal(got.mtx_history, want.mtx_history)
    for k in want.losses_values:
        assert torch.equal(got.losses_values[k], want.losses_values[k]), k
    assert not torch.equal(got.mtx_history[0], got.mtx_history[-1])
    assert B == got.mtx_history.shape[1]
