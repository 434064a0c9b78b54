"""``geometry.quat_rotate`` and ``testing.synthetic_scene`` against the
JAX package's on the same seeded inputs: the rotation at rtol 1e-6; the
scene's gt pose and perturbed initial poses equal to the reference's
(atol 1e-7: the numpy draws are consumed in the reference's order, and
the perturbation's quaternion product is float32 in both), its gt
renders on the brute-force raster (``raster_impl="reference"`` in both)
at the contract: mask and rgb rtol 1e-5, atol 1e-4, depth rtol 1e-5,
atol 1e-6 (tests/test_torch_render_reference.py)."""

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.geometry import quat_rotate
from diffdope_tpu_torch.optimize import pose_matrix
from diffdope_tpu_torch.testing import synthetic_scene
from torch_scene import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shapes", [((6, 4), (6, 3)), ((4,), (9, 3)), ((2, 5, 4), (2, 5, 3))])
def test_torch_quat_rotate_matches_reference(shapes):
    import jax.numpy as jnp

    from diffdope_tpu.geometry import quat_rotate as ref_rotate

    rng = np.random.default_rng(7)
    q = rng.normal(size=shapes[0]).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=shapes[1]).astype(np.float32)
    got = quat_rotate(torch.as_tensor(q), torch.as_tensor(v)).numpy()
    want = np.asarray(ref_rotate(jnp.asarray(q), jnp.asarray(v)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # an active rotation: the rotation matrix of q applied to v
    m = pose_matrix({k: torch.as_tensor(q.reshape(-1, 4)[:, i]) for i, k in
                     enumerate(("qx", "qy", "qz", "qw"))} | {
                        k: torch.zeros(q.reshape(-1, 4).shape[0]) for k in ("x", "y", "z")})[0]
    rot = m[:, :3, :3].reshape(q.shape[:-1] + (3, 3)).numpy()
    np.testing.assert_allclose(got, np.einsum("...ij,...j->...i", rot, v), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(subdiv=1, resolution=(32, 32), batchsize=8, seed=3),
                                dict(subdiv=2, resolution=(40, 56), batchsize=3, seed=11,
                                     perturb_deg=20.0, perturb_trans=0.05, radius=0.3,
                                     distance=2.5)])
def test_torch_synthetic_scene_matches_reference(kw):
    import jax

    from diffdope_tpu.testing import synthetic_scene as ref_scene

    got = synthetic_scene(raster_impl="reference", device="cpu", **kw)
    want = ref_scene(raster_impl="reference", **kw)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["q_gt"], want["q_gt"], atol=1e-7)
    np.testing.assert_allclose(got["t_gt"], want["t_gt"], atol=1e-7)
    assert set(got["params0"]) == set(want["params0"])
    for k, v in want["params0"].items():
        assert got["params0"][k].shape == (kw["batchsize"],)
        np.testing.assert_allclose(got["params0"][k].numpy(), np.asarray(v), atol=1e-7,
                                   err_msg=k)
    for k in ("proj", "pos", "tri", "vtx_color", "edge_adj"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["resolution"] == want["resolution"]
    h, w = kw["resolution"]
    for key, atol in (("rgb", 1e-4), ("segmentation", 1e-4), ("depth", 1e-6)):
        g, r = got["gt"][key].numpy(), np.asarray(want["gt"][key])
        assert g.shape == r.shape == ((h, w) if key == "depth" else (h, w, 3))
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=atol, err_msg=key)
    assert got["gt"]["segmentation"].max() > 0.5
    # the render function at the initial poses, as the reference's
    mtx = pose_matrix(got["params0"])[0]
    with torch.no_grad():
        r_got = got["render_fn"](mtx)
    r_want = jax.jit(want["render_fn"])(mtx.numpy())
    np.testing.assert_allclose(r_got["mask"].numpy(), np.asarray(r_want["mask"]), rtol=1e-5,
                               atol=1e-4)
