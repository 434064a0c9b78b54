"""The compact and the uniform-K table give the same poses (F3).

Both tables hold the same live slots (slot value below the triangle
count) in the same (tile, rank) order and differ only in their sentinel
padding: the compact table pads each tile to whole 128-slot chunks, the
uniform one to K slots.  K2 sums at the compact layout's places (the
compact table's positions; ``pack_kernel.slot_order`` moves the uniform
table's slots there), its plain version over the live slots alone in
table order, and the depth plane's t_z gradient is summed over the
whole padded frame (``pipeline._DepthPlane``), so neither the padding nor
the ROI crop reaches a pose gradient.  Here, on the CPU (the plain
versions):

- ``pack_bwd_plain`` on one live-slot sequence laid out with the
  padding at seeded random places, in chunks of other widths, as the
  uniform table and behind a shifted crop: the same (B, 19) bit for bit;
- ``slot_order`` of the uniform table: the places the compact table of
  the same bins holds its slots at;
- the fused loss on the compact and on the uniform table: the same pose
  gradient at the init bit for bit with the depth term (rgb + mask +
  depth, the test scene; and the bench scene at 160x160, whose compact
  table takes an ROI crop), and without it under f32 d_rows
  (``DD_DROWS_BF16=0``: rgb + mask and mask only); and a 20-step SGD
  ``refine`` from one init takes the same poses at every step;
- ``pack_bwd_plain``'s d_mvp and d_mtx row 2 against the JAX package's
  pack backward (the Pallas pack's VJP, interpret mode) on the JAX
  compact and uniform tables, rtol 2e-4, atol 1e-6.

Under the default bf16 d_rows the mask-only and rgb + mask losses may
still part: the compact table takes the spanning op with bf16 d_rows, the
uniform table f32.
"""

import numpy as np
import pytest
import torch

from torch_scene import (
    jax_compact_table,
    jax_scene,
    jax_uniform_table,
    port_fused_loss,
)
from torch_scene import one_torch_thread  # noqa: F401

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.bench import bench_problem, distinct_poses, drows_env
from diffdope_tpu_torch.optimize import pose_matrix, refine
from diffdope_tpu_torch.render.pack_kernel import (
    _mvpm,
    _static_table,
    live_positions,
    pack_bwd_plain,
)
from diffdope_tpu_torch.render.pipeline import K_CHUNK, slot_order_of


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _tiles():
    """The test scene's uniform table at the init: the fused loss, the
    poses, the per-tile live slots (a list of int64 tensors), and the
    triangle count."""
    sc = convert.state(jax_scene(), "cpu")
    fn = port_fused_loss(use_depth=True, uniform=True)
    with torch.no_grad():
        bn = fn.binned(sc["mtx0"])
    k = bn.flat.numel() // bn.counts.numel()
    flat = bn.flat.reshape(-1, k)
    tiles = [flat[t, : int(c)] for t, c in enumerate(bn.counts)]
    return fn, sc["mtx0"], bn, tiles, fn.mesh.t_count


def _layout(case, tiles, t_count, k):
    """One live-slot sequence laid out by ``case`` (sentinel ``t_count``)."""
    def pad(x, width):
        return torch.cat([x, x.new_full((width - x.numel(),), t_count)])

    live = torch.cat(tiles)
    if case == "live_only":
        return live
    if case == "uniform":
        return torch.cat([pad(x, k) for x in tiles])
    if case.startswith("chunk"):
        c = int(case[len("chunk"):])
        return torch.cat([pad(x, -(-x.numel() // c) * c) for x in tiles])
    if case == "crop_shifted":  # empty tiles before and after the window
        body = torch.cat([pad(x, -(-x.numel() // K_CHUNK) * K_CHUNK) for x in tiles])
        return torch.cat([live.new_full((3 * K_CHUNK,), t_count), body,
                          live.new_full((2 * K_CHUNK,), t_count)])
    seed = int(case[len("random"):])
    rng = np.random.default_rng(seed)
    n = live.numel() + int(rng.integers(1, 3 * live.numel()))
    where = np.sort(rng.choice(n, live.numel(), replace=False))
    out = live.new_full((n,), t_count)
    out[torch.as_tensor(where)] = live
    return out


LAYOUTS = ["uniform", "chunk32", "chunk128", "chunk256", "crop_shifted", "random0",
           "random1", "random2"]


@pytest.mark.parametrize("case", LAYOUTS)
def test_pack_bwd_plain_depends_on_the_live_slots_only(case):
    """``pack_bwd_plain`` on the scene's live slots in ``case``'s layout,
    each live slot's cotangent the same in every layout and seeded noise
    on the padding: (B, 19) bit for bit that of the live slots alone."""
    fn, mtx, bn, tiles, t_count = _tiles()
    k = bn.flat.numel() // bn.counts.numel()
    mvpm = _mvpm(bn.mvp, mtx)
    b = mvpm.shape[0]
    m = sum(x.numel() for x in tiles)
    g_live = torch.randn((b, 32, m), generator=torch.Generator().manual_seed(0))

    def run(flat, seed):
        n = flat.numel()
        tab, n_ch = _static_table(flat, t_count, fn.mesh.static)
        pos = live_positions(tab)
        assert torch.equal(flat[pos], torch.cat(tiles))
        g = torch.randn((b, 32, n), generator=torch.Generator().manual_seed(seed))
        g[:, :, pos] = g_live
        return pack_bwd_plain(mvpm, tab, g, n_ch)

    want = run(_layout("live_only", tiles, t_count, k), 1)
    flat = _layout(case, tiles, t_count, k)
    assert flat.numel() > m
    got = run(flat, 2)
    assert want.abs().max() > 0
    assert torch.equal(_bits(got), _bits(want)), (got - want).abs().max()


@pytest.mark.parametrize("case", ["scene", "bench_crop"])
def test_slot_order_maps_the_uniform_table_to_the_compact_places(case):
    """K2's places: the compact table's are its positions (no order); the
    uniform table's hold, at each place, the slot the compact table of the
    same bins holds there (the crop's tiles; tiles outside it are empty),
    and as many places as the compact table holds chunks' slots."""
    fn_c, fn_u, mtx = _scene_losses("bench_depth" if case == "bench_crop" else "depth")
    with torch.no_grad():
        bc, bu = fn_c.binned(mtx), fn_u.binned(mtx)
    t_count = fn_c.mesh.t_count
    assert slot_order_of(bc, fn_c.mesh) is None
    ou = slot_order_of(bu, fn_u.mesh)
    n_c, n_u = bc.flat.numel(), bu.flat.numel()
    places = int(ou[n_u])
    assert places == int((bc.used * K_CHUNK).sum()) and 0 < places <= n_c
    assert not (bc.flat[places:] < t_count).any()
    held = ou[:places] >= 0
    assert torch.equal(held, bc.flat[:places] < t_count)  # padding: no slot
    assert torch.equal(bu.flat[ou[:places][held].long()], bc.flat[:places][held])


def _pose_grad(fn, mtx):
    m = mtx.detach().clone().requires_grad_(True)
    total, _ = fn(m)
    total.backward()
    return m.grad


def _scene_losses(case):
    """(compact, uniform) fused losses and the init poses of ``case``."""
    if case.startswith("bench"):
        with drows_env(False):
            kw = dict(subdiv=2, batch=3, device="cpu", depth=case == "bench_depth")
            pbs = [bench_problem((160, 160), uniform=u, **kw) for u in (False, True)]
        mtx, _, _ = pose_matrix(distinct_poses(pbs[0]["params0"], 0.01))
        assert pbs[0]["fn"].crop is not None  # the compact table's ROI crop
        return pbs[0]["fn"], pbs[1]["fn"], mtx
    kw = dict(use_depth=case == "depth", use_rgb=case != "mask")
    sc = convert.state(jax_scene(), "cpu")
    return (port_fused_loss(**kw), port_fused_loss(uniform=True, **kw), sc["mtx0"])


@pytest.mark.parametrize("case", ["depth", "rgb_mask", "mask", "bench_depth", "bench_rgb_mask"])
def test_tables_give_equal_pose_gradients(case):
    """The fused loss's pose gradient at the init, compact table against
    uniform table, bit for bit: with the depth term, and without it under
    f32 d_rows (DD_DROWS_BF16=0)."""
    fn_c, fn_u, mtx = _scene_losses(case)
    got, want = _pose_grad(fn_c, mtx), _pose_grad(fn_u, mtx)
    assert want.abs().max() > 0
    assert torch.equal(_bits(got), _bits(want)), (got - want).abs().max()


@pytest.mark.parametrize("case", ["depth", "bench_depth"])
def test_tables_refine_to_the_same_poses(case):
    """20 SGD steps of ``refine`` from one init on each table: the same
    poses at every step, bit for bit, and the poses move.  The steps are
    short enough that neither table drops a slot nor leaks out of the
    crop (a compact table that drops slots holds other slots; DiffDope
    re-runs it with a larger capacity)."""
    fn_c, fn_u, _ = _scene_losses(case)
    if case == "depth":
        sc = convert.state(jax_scene(), "cpu")
        params0, base_lr = {k: v.clone() for k, v in sc["params0"].items()}, 2.0
    else:
        pb = bench_problem((160, 160), subdiv=2, batch=3, device="cpu")
        params0, base_lr = distinct_poses(pb["params0"], 0.01), 0.2
    runs = [refine(params0, fused_loss_fn=fn, nb_iterations=19, base_lr=base_lr,
                   optimizer="sgd") for fn in (fn_c, fn_u)]
    for run in runs:
        for key in ("_bin_overflow", "_crop_leak"):
            assert int(run.telemetry.get(key, torch.zeros(1)).max()) == 0, key
        assert run.total_loss[-1] < run.total_loss[0]
    h_c, h_u = (r.mtx_history for r in runs)
    assert h_c.shape[0] == 20
    assert not torch.equal(h_c[0], h_c[-1])
    parted = (_bits(h_c) != _bits(h_u)).reshape(h_c.shape[0], -1).any(1)
    assert not parted.any(), f"the poses part first at step {int(parted.int().argmax())}"


def _jax_inputs(table):
    """The JAX table's pack inputs (``test_torch_pack_kernel``'s form)."""
    sc = jax_scene()
    t_count = sc["tri"].shape[0]
    pos_c = sc["pos"][sc["tri"].reshape(-1)]
    attrs = sc["vtx_color"][sc["tri"].reshape(-1)].reshape(t_count, 3, 3)
    if table == "compact":
        ref = jax_compact_table()
        flat, mvp, sil = ref["flat"], ref["mvp"], ref["sil"]
    else:
        ref = jax_uniform_table()
        flat = ref["idx"].reshape(-1)
        mvp = np.einsum("ij,bjk->bik", sc["proj"], sc["mtx0"]).astype(np.float32)
        sil = np.zeros((mvp.shape[0], t_count), np.float32)
    return dict(pos_c=pos_c, mvp=np.asarray(mvp, np.float32), mtx=sc["mtx0"],
                flat=np.asarray(flat, np.int32), attrs=attrs, sil=np.asarray(sil, np.float32),
                degen=np.zeros(t_count, bool), t_count=t_count)


@pytest.mark.parametrize("table", ["compact", "uniform"])
def test_pack_bwd_plain_matches_the_jax_pack_backward(table):
    """``pack_bwd_plain`` on the JAX compact and uniform tables (the port's
    static table from the same slot map) against the JAX Pallas pack's
    VJP under one seeded cotangent: d_mvp and row 2 of d_mtx at rtol
    2e-4, atol 1e-6."""
    from test_torch_pack_kernel import _jax_pack

    from diffdope_tpu_torch.render.planar import static_pack_rows

    x = _jax_inputs(table)
    b, n = x["mvp"].shape[0], x["flat"].shape[0]
    assert 0 < int((x["flat"] < x["t_count"]).sum()) < n
    g = np.random.default_rng(11).normal(size=(b, 32, n)).astype(np.float32)
    ref = _jax_pack(x, g)
    pos_c, attrs = torch.tensor(x["pos_c"]), torch.tensor(x["attrs"])
    flat = torch.tensor(x["flat"])
    static = static_pack_rows(pos_c, attrs, torch.tensor(x["degen"]))
    tab, n_ch = _static_table(flat, x["t_count"], static)
    mvpm = _mvpm(torch.tensor(x["mvp"]), torch.tensor(x["mtx"]))
    d = pack_bwd_plain(mvpm, tab, torch.tensor(g), n_ch)
    assert np.abs(ref["d_mvp"]).max() > 0
    np.testing.assert_allclose(d[:, :16].reshape(b, 4, 4).numpy(), ref["d_mvp"],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(d[:, 16:].numpy(), ref["d_mtx"][:, 2, :3], rtol=2e-4,
                               atol=1e-6)
