"""The premise the fused loss backward (K6) relies on to skip work, held in
both packages on the CPU; the bytes its bound counts; and the one PyTorch
call that computes the raster backward's (K4's) function, against its
plain twin (``kernels/check.py``).

(a) K6 evaluates only silhouette pairs (one pixel foreground, the other
not): on a pair of two foreground pixels the mask colour is 1 on both
sides, so diff = 0 and every term the pair adds, to the antialiased mask
and to the edge lanes of d_rows, is +-0.  The backward must then be the
same, bit for bit, with every foreground id replaced by 1 (which turns
every such pair inactive): d_rows, d_dplane and d_colors of the port's
``loss_bwd_plain`` and of the JAX ``backward_pass`` (interpret mode), on
the windows of ``test_torch_fused_loss`` and on one past the real frame,
without and with the depth plane, and on the colour lane of
``test_torch_fused_texture``, without and with depth.

(b) ``kernels.check.bwd_library`` (a ``scatter_add_`` of d_rows by
winner slot, the kernel table's library yardstick) computes K4's function:
it equals ``raster_bwd_plain`` within K4's tolerance on the compact and
the uniform-K table, on f32 and bf16 d_rows.
"""

import numpy as np
import pytest
import torch

from test_torch_fused_loss import D_SUMS, D_SUMS_DEPTH, WINDOWS
from test_torch_fused_texture import _lane_inputs
from test_torch_k2_k5_premises import PAST_FRAME, _windowed
from torch_scene import RES

from diffdope_tpu_torch.kernels import check
from diffdope_tpu_torch.render import fused_loss as tf
from torch_scene import one_torch_thread  # noqa: F401


def _port_bwd(rows, ids, gt6, roi, d_sums, dplane, colors):
    out = tf.loss_bwd_plain(torch.tensor(rows), torch.tensor(ids), torch.tensor(gt6), roi,
                            torch.tensor(d_sums),
                            None if dplane is None else torch.tensor(dplane),
                            None if colors is None else torch.tensor(colors))
    return [None if x is None else x.numpy() for x in out]


def _jax_bwd(rows, ids, gt6, res, jroi, d_sums, dplane, colors):
    import jax.numpy as jnp

    from diffdope_tpu.render.fused_loss import backward_pass

    out = backward_pass(jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(gt6),
                        None if dplane is None else jnp.asarray(dplane),
                        None if colors is None else jnp.asarray(colors), res,
                        4 if colors is None else 3, True, jnp.asarray(d_sums), roi=jroi)
    return [None if x is None else np.asarray(x) for x in out]


def _case(name):
    """(rows, ids, gt6, dplane, colors, res, jroi, troi) of a case: a window
    of the compact raster (rgb + mask lane), or the textured scene's full
    frame with colour planes (the colour lane)."""
    if name == "colour":
        rows, ids, gt6, dplane, colors = _lane_inputs()
        return rows, ids, gt6, dplane, colors, RES, None, (0, 0) + RES
    rows, ids, gt6, dplane, res, jroi, troi = _windowed(
        PAST_FRAME if name == "past_frame" else WINDOWS[name])
    return rows, ids, gt6, dplane, None, res, jroi, troi


@pytest.mark.parametrize("depth", [False, True], ids=["no_depth", "depth"])
@pytest.mark.parametrize("name", sorted(WINDOWS) + ["past_frame", "colour"])
def test_k6_premise_foreground_pairs_add_nothing(name, depth):
    rows, ids, gt6, dplane, colors, res, jroi, troi = _case(name)
    one = np.where(ids > 0, 1, 0).astype(ids.dtype)
    # pairs of two foreground pixels on different triangles: what changes
    fg = ids > 0
    assert ((fg[:, :, 1:] & fg[:, :, :-1]) & (ids[:, :, 1:] != ids[:, :, :-1])).any()
    # both id maps in one call of each package: the hypotheses are
    # independent, so the first half is the full ids' backward, the second
    # the collapsed ids'
    b = ids.shape[0]

    def twice(a):
        return None if a is None else np.concatenate([a, a])

    dpl = twice(dplane) if depth else None
    d_sums = twice(D_SUMS_DEPTH if depth else D_SUMS)
    for run, args in ((_port_bwd, (gt6, troi, d_sums, dpl, twice(colors))),
                      (_jax_bwd, (gt6, res, jroi, d_sums, dpl, twice(colors)))):
        out = run(twice(rows), np.concatenate([ids, one]), *args)
        assert np.abs(out[0][:b, :9]).max() > 0  # the mask term reaches the edge lanes
        for both in out:
            if both is not None:
                np.testing.assert_array_equal(both[b:], both[:b], err_msg=run.__name__)


@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k6_bound_counts_the_bytes_it_moves(depth, colors, dtype):
    """K6's bytes: ids and the six gt planes of every pixel, the row lanes
    K5 reads (``k5_row_lanes``: the redesigned K6 reads no others), the
    depth or colour planes in and their cotangents out, the (B, 3)
    cotangent, and 32 d_rows lanes of every pixel (2 bytes each in bf16)."""
    ids = torch.zeros((2, 12, 16), dtype=torch.int32)
    ids[0, 3:7, 4:9] = 5  # a 4 x 5 block: 14 of its 20 pixels on its edge
    ids[1, 3:7, 4:9] = 6
    ids[1, 3:7, 6:9] = 7  # two triangles, the same silhouette
    ids[:, 10:, :] = 9  # past the frame
    roi = (0, 0, 10, 16)
    npx = 2 * 12 * 16
    shaded = (0 if colors else 3) + (1 if depth else 0)
    lanes = 2 * 20 * (9 + 3 * shaded if shaded else 0) + 2 * 14 * (2 + (0 if shaded else 9))
    planes = (4 if depth else 0) + (12 if colors else 0)
    d_rows = 2 if dtype == "bf16" else 4
    want = 4 * npx + 4 * 6 * 12 * 16 + 4 * lanes + 2 * planes * npx + 4 * 2 * 3 \
        + d_rows * 32 * npx
    got = check.loss_bwd_bytes(ids, roi, depth, colors,
                               torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert check.k5_row_lanes(ids, roi, depth, colors) == lanes
    assert got == want


@pytest.mark.parametrize("table", ["compact", "uniform"])
def test_k4_library_call_matches_plain(table):
    """On the test scene's table at its distinct poses: the library call's
    d_bins within K4's tolerance of the plain twin's, on f32 and bf16
    d_rows, per slot and per triangle."""
    from diffdope_tpu_torch.bench import bench_problem, distinct_poses
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.raster import raster_bwd_plain

    problem = bench_problem(RES, subdiv=2, batch=3, device="cpu",
                            uniform=table == "uniform")
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 0.01))
    spec = check._binned_spec(problem["fn"], mtx, 0)
    n_slots = spec.packed.shape[2]
    ids, rows, win = spec.fwd()
    assert (win >= 0).sum() > 0 and (win < 0).sum() > 0
    gen = torch.Generator().manual_seed(0)
    d_rows = torch.randn(rows.shape, generator=gen)
    for d in (d_rows, d_rows.to(torch.bfloat16)):
        got = check.bwd_library(d, win, n_slots)
        want = raster_bwd_plain(d, win, n_slots)
        scale = raster_bwd_plain(d.abs(), win, n_slots)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert check._close(got, want, 2e-4, 1e-6, scale)
        assert want.abs().max() > 0
