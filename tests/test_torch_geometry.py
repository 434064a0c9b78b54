"""Port parity: geometry, mesh topology, test meshes and the optimizers.

Same numpy-seeded inputs through the JAX reference and the port: values
and gradients of the pose math, the edge adjacency and icosphere arrays
bit-equal, and the optax-semantics SGD/Adam updates step for step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffdope_tpu import geometry as jgeo
from diffdope_tpu import optimize as jopt
from diffdope_tpu_torch import geometry as tgeo
from diffdope_tpu_torch import optimize as topt
from torch_scene import one_torch_thread  # noqa: F401


def _vjp_pair(jfn, tfn, inputs, seed):
    """Values and input gradients (cotangent drawn from ``seed``) of a JAX
    function and its port on the same float32 inputs."""
    jin = [jnp.asarray(a) for a in inputs]
    jout, pull = jax.vjp(jfn, *jin)
    ct = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(np.float32)
    jgrads = pull(jnp.asarray(ct))
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    tout = tfn(*tin)
    tgrads = torch.autograd.grad(tout, tin, grad_outputs=torch.tensor(ct))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jgrads], [g.numpy() for g in tgrads])


@pytest.mark.parametrize(
    "name", ["quat_normalize", "quat_multiply", "matrix44_from_quat_trans",
             "pose_matrix"]
)
def test_torch_pose_math_values_and_grads(name):
    rng = np.random.default_rng(7)
    q1 = rng.normal(size=(5, 4)).astype(np.float32)
    q2 = rng.normal(size=(5, 4)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    if name == "quat_normalize":
        args = (jgeo.quat_normalize, tgeo.quat_normalize, [q1])
    elif name == "quat_multiply":
        args = (jgeo.quat_multiply, tgeo.quat_multiply, [q1, q2])
    elif name == "matrix44_from_quat_trans":
        args = (lambda q, tt: jgeo.matrix44_from_quat_trans(jgeo.quat_normalize(q), tt),
                lambda q, tt: tgeo.matrix44_from_quat_trans(tgeo.quat_normalize(q), tt),
                [q1, t])
    else:
        keys = ("qx", "qy", "qz", "qw", "x", "y", "z")
        flat = [q1[:, i] for i in range(4)] + [t[:, i] for i in range(3)]
        args = (lambda *p: jopt.pose_matrix(dict(zip(keys, p)))[0],
                lambda *p: topt.pose_matrix(dict(zip(keys, p)))[0], flat)
    jv, tv, jg, tg = _vjp_pair(*args, seed=3)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_torch_host_geometry_bit_equal():
    axis, angle = np.array([0.3, -1.0, 0.2]), 0.7
    np.testing.assert_array_equal(
        tgeo.quat_from_axis_angle(axis, angle), jgeo.quat_from_axis_angle(axis, angle)
    )
    for wc in ("y_down", "y_up"):
        np.testing.assert_array_equal(
            tgeo.projection_from_intrinsics(500, 480, 200, 190, 400, 380, 0.01, 100.0, wc),
            jgeo.projection_from_intrinsics(500, 480, 200, 190, 400, 380, 0.01, 100.0, wc),
        )


@pytest.mark.parametrize("subdiv", [0, 2])
def test_torch_icosphere_and_adjacency_bit_equal(subdiv):
    from diffdope_tpu.mesh import build_edge_adjacency as j_adj
    from diffdope_tpu.testing import icosphere as j_ico
    from diffdope_tpu_torch.mesh import build_edge_adjacency as t_adj
    from diffdope_tpu_torch.testing import icosphere as t_ico

    jv, jf = j_ico(subdiv)
    tv, tf = t_ico(subdiv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(t_adj(tf), np.asarray(j_adj(jf)))
    # an open mesh: boundary edges are -1 in both
    np.testing.assert_array_equal(t_adj(tf[:7]), np.asarray(j_adj(jf[:7])))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_torch_optimizer_matches_optax(optimizer):
    """Five updates of the port's optimizer against optax (the reference's
    optimizer) on the same gradients, schedule included: in place, each
    step's scalars a row of the run's tables, as ``refine`` runs them."""
    rng = np.random.default_rng(11)
    params = {k: rng.normal(size=4).astype(np.float32) for k in ("qx", "x")}
    grads = [{k: rng.normal(size=4).astype(np.float32) for k in params} for _ in range(5)]
    base_lr, decay, nb = 0.02, 0.1, 4
    jo = jopt.make_optimizer(optimizer, base_lr, decay, nb)
    to = topt.make_optimizer(optimizer, base_lr, decay, nb)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    tables = to.tables(ts["count"], len(grads))
    import optax

    for i, g in enumerate(grads):
        upd, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        row = {name: torch.as_tensor(t[i]) for name, t in tables.items()}
        to.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp, row)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
