"""No floating-point sum through autograd's scatters on any route.

Autograd's transposes of a gather (``gather``, advanced indexing,
``index_select``, ``embedding``) add their cotangents with atomics on the
card, so a step's gradient would change from run to run.  The port routes
every gather whose source takes a gradient through its deterministic
gathers (``rasterize.IndexRows``, ``rasterize.SetupRows``), whose backward
sums each source row's cotangents in ascending entry order: the segmented
sum on the card, ``index_add_`` in index order on the CPU.  Held here, on
the CPU:

(a) two steps of every route of ``test_torch_refine_capture.ROUTES`` and of
the vertex-colour and corner-colour appearance leaves call no
floating-point ``scatter_add``, ``scatter_reduce``, ``index_add``,
``index_reduce``, ``put_``, ``embedding_dense_backward`` or
``index_put`` with accumulate, from each step's ``pose_matrix`` through
its backward and update (the kernels' plain twins, which a CUDA tensor
never reaches, paused); integer sums, exact in any order, pass;

(b) the backward of ``IndexRows`` on a source shared by the B
hypotheses (batch 1): the sum, in ascending flat entry order (hypothesis
by hypothesis, each in ascending entry order), of the valid entries'
cotangents, bit for bit, where it leaves out the entries whose cotangent
is zero;

(c) the rerouted gathers' gradients: ``shade_rows``' packed rows, the
sum of the foreground pixels in ascending order; the texture of every
sampler under every boundary mode, at one hypothesis equal bit for bit to
the gradient through autograd's gathers (the same order of additions).
"""

import importlib

import numpy as np
import pytest
import torch

import test_torch_refine_capture as capture
from torch_scene import one_torch_thread  # noqa: F401

from diffdope_tpu_torch.optimize import refine
from diffdope_tpu_torch.render.rasterize import IndexRows


class FloatScatters(capture.HostSyncs):
    """Raise on an accumulating scatter of floating-point values while
    armed and not paused (``capture.syncs_for`` arms and pauses it)."""

    SUMS = {"scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
            "index_add", "index_add_", "index_reduce", "index_reduce_", "put", "put_",
            "embedding_dense_backward"}
    PUTS = {"index_put", "index_put_", "_index_put_impl_"}
    SCATTERS = {"scatter", "scatter_"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.armed and not self.paused:
            self.ops += 1
            name = func.overloadpacket.__name__
            floating = (isinstance(args[0], torch.Tensor) and args[0].is_floating_point())
            summing = (name in self.SUMS
                       or (name in self.PUTS and (kwargs.get("accumulate")
                                                  or (len(args) > 3 and args[3])))
                       or (name in self.SCATTERS and kwargs.get("reduce") is not None))
            if summing and floating:
                raise AssertionError(f"a step sums floats through {func}")
        return func(*args, **kwargs)


LEAVES = ("vtx_color", "corner_colors")
CASES = sorted(capture.ROUTES) + [f"appearance_{leaf}" for leaf in LEAVES]


def build(case, monkeypatch, device="cpu"):
    """A case's ``(params0, refine keywords)`` on ``device``
    (``tests/test_torch_cuda.py`` builds them on the card)."""
    leaf = case[len("appearance_"):] if case.startswith("appearance_") else None
    if leaf:
        return capture._appearance(monkeypatch, device, leaf=leaf)
    return capture.ROUTES[case](monkeypatch, device)


def optimizer_of(case):
    return capture.optimizer_of("appearance" if case.startswith("appearance") else case)


@pytest.mark.parametrize("case", CASES)
def test_torch_step_sums_no_float_through_a_scatter(case, monkeypatch):
    params0, kw = build(case, monkeypatch)
    optimizer, base_lr = optimizer_of(case)
    with capture.syncs_for(monkeypatch, FloatScatters()) as mode:
        res = refine(params0, nb_iterations=1, base_lr=base_lr, optimizer=optimizer,
                     step_callback=mode.callback, **kw)
    assert mode.steps == 2 and mode.ops > 0
    assert bool(torch.isfinite(res.total_loss).all())
    moved = [k for k, v in params0.items() if not torch.equal(res.params[k], v)]
    assert moved
    if "extra_params" in kw:  # the appearance leaf took a gradient and moved
        (leaf,) = kw["extra_params"]
        assert not torch.equal(res.params[leaf], kw["extra_params"][leaf])


def _ascending_sum(n_rows, idx, valid, d):
    """Row r the f32 sum, in ascending flat entry order, of d's entries
    with idx = r where valid."""
    want = torch.zeros((n_rows, d.shape[-1]))
    for q in range(idx.numel()):
        if valid.reshape(-1)[q]:
            r = idx.reshape(-1)[q]
            want[r] = want[r] + d.reshape(-1, d.shape[-1])[q]
    return want


def test_torch_index_rows_shared_source_sums_in_flat_order():
    rng = np.random.default_rng(1)
    b, n, p, w = 4, 9, 150, 3
    src = torch.tensor(rng.normal(size=(1, n, w)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, n, size=(b, p)))
    valid = torch.tensor(rng.uniform(size=(b, p)) < 0.8)
    d = torch.tensor(rng.normal(size=(b, p, w)).astype(np.float32))
    # rows of zero cotangent (as masked outputs give), +0 and -0: left out
    # of the sums, which stay those of every valid entry bit for bit
    d[:, ::3] = 0.0
    d[:, 1::5] = -0.0
    out = IndexRows.apply(src, idx, valid)
    assert out.shape == (b, p, w)
    assert torch.equal(out, src.expand(b, -1, -1).gather(1, idx[..., None].expand(-1, -1, w)))
    (g,) = torch.autograd.grad(out, src, d)
    assert g.shape == (1, n, w)
    assert torch.equal(g[0], _ascending_sum(n, idx, valid, d))


def test_torch_shade_rows_gradient_is_the_ordered_sum():
    from diffdope_tpu_torch.render.shade import shade_rows

    rng = np.random.default_rng(2)
    t, res = 6, (5, 7)
    ids = torch.tensor(rng.integers(0, t + 1, size=(1,) + res), dtype=torch.int32)
    packed = torch.tensor(rng.normal(size=(1, t, 32)).astype(np.float32),
                          requires_grad=True)
    rows = shade_rows(ids, packed, res)["rows"]
    d = torch.tensor(rng.normal(size=rows.shape).astype(np.float32))
    (g,) = torch.autograd.grad(rows, packed, d)
    d_px = d.reshape(1, 32, -1).permute(0, 2, 1)
    idx = (ids.long() - 1).clamp(min=0).reshape(1, -1)
    assert torch.equal(g[0], _ascending_sum(t, idx, ids.reshape(1, -1) > 0, d_px))


def _autograd_gather(src, idx, valid=None):
    """The gather the samplers took before: autograd's, whose backward is
    a scatter-add (in index order on the CPU)."""
    if idx.dim() == 1:
        idx = idx.expand(src.shape[0], -1)
    full = src.expand(idx.shape[0], -1, -1)
    return full.gather(1, idx[..., None].expand(-1, -1, src.shape[2]))


SAMPLERS = ("nearest", "linear", "linear-mipmap-nearest", "linear-mipmap-linear", "planar")


@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_torch_texture_gradient_is_the_ordered_sum(sampler, boundary_mode, monkeypatch):
    """One hypothesis: each texel sums its taps' cotangents in ascending
    pixel order, tap by tap, as autograd's scatter-add does on the CPU,
    so the texture's gradient is the parent sampler's bit for bit."""
    texture_module = importlib.import_module("diffdope_tpu_torch.render.texture")
    rng = np.random.default_rng(3)
    th, tw, c = 8, 4, 3
    tex = torch.tensor(rng.uniform(size=(th, tw, c)).astype(np.float32), requires_grad=True)
    uv = torch.tensor(rng.uniform(-0.3, 1.3, size=(1, 6, 7, 2)).astype(np.float32))
    uv_da = torch.tensor(rng.uniform(-0.3, 0.3, size=(1, 6, 7, 4)).astype(np.float32))

    def sample():
        if sampler == "planar":
            return torch.stack(texture_module.texture_planar(tex, uv[..., 0], uv[..., 1],
                                                             boundary_mode), dim=-1)
        return texture_module.texture(tex, uv, uv_da, sampler, boundary_mode)

    out = sample()
    d = torch.tensor(rng.normal(size=out.shape).astype(np.float32))
    (g,) = torch.autograd.grad(out, tex, d)
    assert bool(g.abs().max() > 0)
    monkeypatch.setattr(texture_module, "gather_rows", _autograd_gather)
    want = sample()
    assert torch.equal(out, want)
    (g_want,) = torch.autograd.grad(want, tex, d)
    assert torch.equal(g, g_want)
