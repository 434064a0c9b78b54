"""Port parity for the pack (K1/K2): the JAX Pallas pack
(pack_kernel.pack_binned_pallas, interpret mode) against the port's
pack_binned_auto, which on CPU tensors is the plain planar.pack_binned
and its autograd, on the same static table, poses and silhouette bits.

Tolerances: the table lanes as in tests/test_torch_planar.py (XLA's CPU
fusions contract a*b + c into FMAs; the lanes are cancelling sums of
products: rtol 1e-6, atol 2e-6); the VJP (d_mvp, d_mtx) rtol 2e-4, atol
1e-6."""

import numpy as np
import pytest
import torch

from torch_scene import jax_compact_table, jax_scene

from diffdope_tpu_torch.render import pack_kernel as tpk
from diffdope_tpu_torch.render.planar import static_pack_rows
from torch_scene import one_torch_thread  # noqa: F401


def _inputs_scene():
    """The torch_scene compact table's pack inputs at its initial poses."""
    sc, ref = jax_scene(), jax_compact_table()
    t_count = sc["tri"].shape[0]
    pos_c = sc["pos"][sc["tri"].reshape(-1)]
    attrs = sc["vtx_color"][sc["tri"].reshape(-1)].reshape(t_count, 3, 3)
    return dict(pos_c=pos_c, mvp=ref["mvp"], mtx=sc["mtx0"], flat=ref["flat"],
                attrs=attrs, sil=ref["sil"], degen=np.zeros(t_count, bool),
                t_count=t_count)


def _inputs_random(n_ch, b=4, t=37, n=293, seed=0):
    """The reference test's random problem (tests/test_pack_kernel.py:20-45):
    sentinel slots, degenerate triangles, some corners behind the camera."""
    rng = np.random.default_rng(seed)
    pos_c = rng.normal(size=(3 * t, 3)).astype(np.float32)
    mvp = (np.eye(4, dtype=np.float32) + 0.1 * rng.normal(size=(b, 4, 4))).astype(np.float32)
    mvp[:, 3, 3] += 3.0
    mtx = (np.eye(4, dtype=np.float32) + 0.1 * rng.normal(size=(b, 4, 4))).astype(np.float32)
    flat = rng.integers(0, t + 1, size=n).astype(np.int32)
    attrs = rng.uniform(size=(t, 3, n_ch)).astype(np.float32) if n_ch else None
    degen = rng.uniform(size=t) < 0.2
    sil = rng.integers(0, 8, size=(b, t)).astype(np.float32)
    return dict(pos_c=pos_c, mvp=mvp, mtx=mtx, flat=flat, attrs=attrs, sil=sil,
                degen=degen, t_count=t)


def _jax_pack(x, g):
    """The reference's static table, Pallas pack and its VJP under g."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render import pack_kernel as jpk

    t_count = x["t_count"]
    flat = jnp.asarray(x["flat"])
    tab, n_ch = jpk._static_table(
        jnp.asarray(x["pos_c"]), None if x["attrs"] is None else jnp.asarray(x["attrs"]),
        jnp.asarray(x["degen"]), flat, t_count)
    sil_b = jnp.take(jnp.asarray(x["sil"]), jnp.minimum(flat, t_count - 1),
                     axis=1).astype(jnp.float32)
    out, vjp = jax.vjp(
        lambda m, p: jpk.pack_binned_pallas(m, p, tab, sil_b, n_ch, True),
        jnp.asarray(x["mvp"]), jnp.asarray(x["mtx"]))
    d_mvp, d_mtx = vjp(jnp.asarray(g))
    return dict(tab=np.asarray(tab), mvpm=np.asarray(jpk._mvpm(x["mvp"], x["mtx"])),
                out=np.asarray(out), d_mvp=np.asarray(d_mvp), d_mtx=np.asarray(d_mtx))


def _port_pack(x, g):
    pos_c = torch.tensor(x["pos_c"])
    attrs = None if x["attrs"] is None else torch.tensor(x["attrs"])
    degen = torch.tensor(x["degen"])
    flat = torch.tensor(x["flat"])
    static = static_pack_rows(pos_c, attrs, degen)
    mvp = torch.tensor(x["mvp"], requires_grad=True)
    mtx = torch.tensor(x["mtx"], requires_grad=True)
    out = tpk.pack_binned_auto(pos_c, mvp, mtx, flat, attrs, torch.tensor(x["sil"]), degen,
                               x["t_count"], static)
    d_mvp, d_mtx = torch.autograd.grad(out, (mvp, mtx), torch.tensor(g))
    tab, _ = tpk._static_table(flat, x["t_count"], static)
    return dict(tab=tab.numpy(), mvpm=tpk._mvpm(mvp.detach(), mtx.detach()).numpy(),
                out=out.detach().numpy(), d_mvp=d_mvp.numpy(), d_mtx=d_mtx.numpy())


@pytest.mark.parametrize("case", ["scene", "random_rgb", "random_no_attrs"])
def test_torch_pack_matches_pallas_pack(case):
    x = {"scene": _inputs_scene,
         "random_rgb": lambda: _inputs_random(3),
         "random_no_attrs": lambda: _inputs_random(0)}[case]()
    b, n = x["mvp"].shape[0], x["flat"].shape[0]
    g = np.random.default_rng(7).normal(size=(b, 32, n)).astype(np.float32)
    ref, got = _jax_pack(x, g), _port_pack(x, g)
    # the kernel inputs are the reference's, exactly
    np.testing.assert_array_equal(got["tab"], ref["tab"])
    np.testing.assert_array_equal(got["mvpm"], ref["mvpm"])
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-6, atol=2e-6)
    assert np.abs(ref["d_mvp"]).max() > 0
    np.testing.assert_allclose(got["d_mvp"], ref["d_mvp"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got["d_mtx"], ref["d_mtx"], rtol=2e-4, atol=1e-6)
    # only row 2, columns 0-2 of the pose carry a gradient through the pack
    rest = got["d_mtx"].copy()
    rest[:, 2, :3] = 0.0
    assert not rest.any()


def test_torch_pack_eligibility_and_devices():
    """The reference's eligibility rules, and no fallback: the launchers
    refuse CPU tensors, the dispatch refuses devices that are neither."""
    x = _inputs_random(3)
    pos_c = torch.tensor(x["pos_c"])
    attrs = torch.tensor(x["attrs"])
    assert tpk._eligible(pos_c, attrs)
    assert tpk._eligible(pos_c, None)
    assert not tpk._eligible(pos_c.clone().requires_grad_(True), attrs)
    assert not tpk._eligible(pos_c, attrs.clone().requires_grad_(True))
    assert not tpk._eligible(pos_c, attrs[..., None])
    mvpm = torch.zeros((4, 20))
    tab = torch.zeros((9 + 9 + 2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.pack_fwd(mvpm, tab, torch.zeros((4, 8)), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.pack_bwd(mvpm, tab, torch.zeros((4, 32, 8)), 3)
    meta = torch.zeros((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.pack_binned_auto(pos_c, meta, meta, torch.zeros(8, dtype=torch.int32), attrs,
                             torch.zeros((4, 37)), None, 37,
                             static_pack_rows(pos_c, attrs, None))
