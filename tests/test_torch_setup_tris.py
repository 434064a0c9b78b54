"""Port parity for the API ops' triangle setup and binning
(diffdope_tpu/render/setup_tris.py against diffdope_tpu_torch/render/
setup_tris.py) and for ``geometry.xfm_points`` / ``xfm_vectors``.

The packed coefficients agree at rtol 1e-5, atol 1e-6, not bit for bit:
``jnp.cross`` is jitted, and XLA's CPU fusion contracts its a*b - c*d into
an FMA, while the port rounds each product (the same order on every
device).  Degenerate rows are exactly 0 on both sides.  The binning is
held bit for bit on the same corners and determinants: indices, counts
and overflow, with a triangle behind the camera and an overflowing K.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffdope_tpu import geometry as j_geo
from diffdope_tpu.render import setup_tris as j_setup
from diffdope_tpu_torch import geometry as t_geo
from diffdope_tpu_torch.render import setup_tris as t_setup
from torch_scene import random_clip_scene as random_scene
from torch_scene import one_torch_thread  # noqa: F401

RES = (40, 150)  # a multiple of neither tile below


def test_torch_triangle_setup_matches_reference():
    pos, tri = random_scene()
    want = np.asarray(j_setup.triangle_setup(jnp.asarray(pos), jnp.asarray(tri)).coef)
    got = t_setup.triangle_setup(torch.tensor(pos), torch.tensor(tri)).coef.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[:, 5].any() and not want[:, 5].any()  # the repeated index


def test_torch_triangle_setup_from_corners_matches_reference():
    """Corner input; the padding row (three bit-identical corners) is found
    positionally and zeroed."""
    pos, tri = random_scene(seed=3)
    corners = pos[:, tri]
    corners[:, 9] = corners[:, 9, :1]
    want = np.asarray(j_setup.triangle_setup_from_corners(jnp.asarray(corners)).coef)
    got = t_setup.triangle_setup_from_corners(torch.tensor(corners)).coef.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[:, 9].any() and not want[:, 9].any()
    assert got[:, :, 13:].sum() == 0


def test_torch_pixel_ndc_matches_reference():
    for got, want in zip(t_setup.pixel_ndc(RES), j_setup.pixel_ndc(RES)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile,k,margin,behind,overflows", [
    ((16, 32), 64, 0.0, False, False),
    ((32, 128), 64, 0.0, True, False),
    ((32, 128), 8, 0.0, False, True),  # the first 8 of each tile stay
    ((16, 32), 16, 3.5, True, True),
])
def test_torch_bin_triangles_matches_reference(tile, k, margin, behind, overflows):
    pos, tri = random_scene(behind=behind)
    corners = pos[:, tri]
    det = np.asarray(j_setup.triangle_setup(jnp.asarray(pos), jnp.asarray(tri)).det)
    want = j_setup.bin_triangles(jnp.asarray(corners), jnp.asarray(det), RES, tile, k,
                                 margin_px=margin)
    got = t_setup.bin_triangles(torch.tensor(corners), torch.tensor(det), RES, tile, k,
                                margin_px=margin)
    for g, w_, name in zip(got, want, ("idx", "counts", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)
    idx, counts, overflow = (g.numpy() for g in got)
    assert idx.dtype == np.int32 and idx.shape[1] % 128 == 0
    assert (np.diff(idx, axis=1) >= 0).all()  # ascending, sentinel padded
    if behind:  # a corner behind the camera: triangle 7 in every tile
        assert (idx == 7).any(axis=1).all()
    assert (int(overflow) > 0) == overflows


@pytest.mark.parametrize("batched", [False, True])
def test_torch_xfm_points_matches_reference(batched):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=((3,) if batched else ()) + (50, 3)).astype(np.float32)
    mtx = rng.normal(size=(3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        t_geo.xfm_points(torch.tensor(pts), torch.tensor(mtx)).numpy(),
        np.asarray(j_geo.xfm_points(jnp.asarray(pts), jnp.asarray(mtx))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t_geo.xfm_vectors(torch.tensor(pts), torch.tensor(mtx)).numpy(),
        np.asarray(j_geo.xfm_vectors(jnp.asarray(pts), jnp.asarray(mtx))),
        rtol=1e-5, atol=1e-6)
