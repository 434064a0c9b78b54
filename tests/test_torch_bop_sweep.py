"""The port's BOP sweep (``diffdope_tpu_torch/bop.py``) against the JAX
package's, on trees of perturbation JSONs written under ``tmp_path`` (the
repo holds no BOP data):

- ``_sweep_synth_objects`` at a tiny size (an icosphere(1) stand-in in
  millimetres, 48x48, B=2, 3 iterations, two objects, the uniform-K table
  as off the TPU): each entry's 'add_init'/'adds_init' at rtol 1e-6 (the
  second object's init proves the numpy stream is consumed as the
  reference consumes it), each refinement's loss history (the total and
  every term, per step and hypothesis) and 'final_loss' rtol 1e-4,
  'add'/'adds' rtol 1e-4, 'best_step' and 'best_hyp' exactly; the
  reference's loss scales (``jax.random``) fed to the port; the same
  with the init jitter and one restart on, the reference's jitter draws
  fed to the port as well;
- ``sweep_perturbation_levels``' aggregation, given the same per-object
  entries (the worker monkeypatched in both), exactly the reference's;
  ``find_error_scenes`` and the ``shard`` partition on the same tree;
- the overflow / crop-leak recovery loop with a fake context, as the
  reference's own test drives it (``tests/test_bop_sweep.py:70``)."""

import json

import numpy as np
import pytest
import torch

from torch_scene import jax_jitter_draws
from torch_scene import one_torch_thread  # noqa: F401

LEVEL = "deg_010_trans_004"
RES = (48, 48)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    return [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]


def _objects(seed, n):
    rng = np.random.default_rng(seed)
    return [{"cam_R_m2c": _rotation(rng), "cam_t_m2c": [0.0, 0.0, 600.0], "obj_id": i + 1}
            for i in range(n)]


def _write_tree(root, scenes, levels, n_obj=2, frames=("0",)):
    """data/hope/<split>/<scene>/scene_error_<level>.json files."""
    for i, scene_id in enumerate(scenes):
        d = root / "hope" / scene_id
        d.mkdir(parents=True)
        for lv in levels:
            with open(d / f"scene_error_{lv}.json", "w") as f:
                json.dump({fr: _objects(10 * i + int(fr), n_obj) for fr in frames}, f)
    return root


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """icosphere(1), radius 40 mm, vertex-coloured, as a PLY."""
    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import icosphere

    path = tmp_path_factory.mktemp("standin") / "ico.ply"
    v, f = icosphere(1)
    save_ply(path, v * 40.0, f, colors=v * 0.5 + 0.5)
    return path


def _recording(run, store):
    """``run`` (a context's refinement), its results' loss histories kept."""
    def wrapped(*args, **kwargs):
        result = run(*args, **kwargs)
        store.append({"total": np.asarray(result.total_loss),
                      **{k: np.asarray(v) for k, v in result.losses_values.items()}})
        return result
    return wrapped


@pytest.fixture(scope="module", params=["adam", "sgd"])
def synth(request, stand_in):
    """Both packages' ``_sweep_synth_objects`` on the same two objects, each
    context built first so its refinement records the loss histories."""
    from diffdope_tpu import bop as ref_bop

    from diffdope_tpu_torch import bop

    opt = request.param
    kw = dict(optimizer=opt, base_lr=0.02 if opt == "adam" else 3.0)
    objs = _objects(5, 2)
    config = (str(stand_in), RES, 2, 3, 0.01, 0)
    args = (objs, LEVEL, "val/000001", "0", str(stand_in), 0.01, RES, 2, 3, 0,
            lambda *a: None)
    hist_ref, hist_port = [], []
    ref_bop._synth_ctx_cache.clear()
    ref_bop._synth_escalation.clear()
    ref_ctx = ref_bop._synth_context(*config, **kw)
    ref_ctx["jit_refine"] = _recording(ref_ctx["jit_refine"], hist_ref)
    want = ref_bop._sweep_synth_objects(*args, **kw)
    assert list(ref_bop._synth_ctx_cache.values()) == [ref_ctx]
    lrs = torch.tensor(np.asarray(ref_ctx["lrs"]))
    ref_bop._synth_ctx_cache.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bop, "draw_learning_rates", lambda *a, **k: lrs)
        bop._synth_ctx_cache.clear()
        bop._synth_escalation.clear()
        ctx = bop._synth_context(*config, device="cpu", **kw)
        ctx["refine"] = _recording(ctx["refine"], hist_port)
        got = bop._sweep_synth_objects(*args, device="cpu", **kw)
        assert list(bop._synth_ctx_cache.values()) == [ctx]
        bop._synth_ctx_cache.clear()
    return dict(got=got, want=want, ctx=ctx, lrs=lrs, hist_ref=hist_ref,
                hist_port=hist_port)


def test_torch_synth_objects_match_reference(synth):
    got, want = synth["got"], synth["want"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
        for key in ("scene", "frame", "i_obj", "obj_id", "best_step", "best_hyp"):
            assert g[key] == w[key], key
        for key in ("add_init", "adds_init", "diameter"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)
        for key in ("final_loss", "add", "adds"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)
    # the two objects start from different perturbations of their own poses
    assert got[0]["add_init"] != got[1]["add_init"]
    # each refinement's loss history: the total and every term, per step
    # and hypothesis
    assert len(synth["hist_port"]) == len(synth["hist_ref"]) == 2
    for hp, hr in zip(synth["hist_port"], synth["hist_ref"]):
        assert set(hp) == set(hr) == {"total", "rgb", "mask_selection"}
        for key in hr:
            assert hp[key].shape == hr[key].shape
            np.testing.assert_allclose(hp[key], hr[key], rtol=1e-4, err_msg=key)


def test_torch_synth_context_off_the_card(synth):
    """Off the card the uniform-K table and the reference's 1,024 cap,
    aligned to the port's chunk; the reference's loss scales were fed."""
    ctx = synth["ctx"]
    assert ctx["compact_total"] is None
    assert ctx["max_tris_per_tile"] == 1024
    assert torch.equal(ctx["lrs"], synth["lrs"])
    assert ctx["fused"].crop is None and ctx["fused"].gt6 is None


def test_torch_synth_objects_jitter_restarts_match_reference(stand_in, monkeypatch):
    """With the init jitter and a restart on, the numpy stream still gives
    the reference's inits (the jitter's integer is drawn before the
    restart's), and the restart segments run the deferred loss with each
    object's own ground truth.  The reference's ``jax.random`` draws are
    fed to the port: the init jitter's from ``PRNGKey(integer)``, each
    re-seed's from the next split of the restart key."""
    import jax

    from diffdope_tpu import bop as ref_bop

    from diffdope_tpu_torch import bop

    init_jitter, restart_jitter = (5.0, 0.005), (10.0, 0.02)
    kw = dict(optimizer="adam", base_lr=0.02, init_jitter=init_jitter, restarts=1,
              restart_jitter=restart_jitter)
    args = (_objects(5, 2), LEVEL, "val/000001", "0", str(stand_in), 0.01, RES, 2, 3, 0,
            lambda *a: None)
    ref_bop._synth_ctx_cache.clear()
    ref_bop._synth_escalation.clear()
    want = ref_bop._sweep_synth_objects(*args, **kw)
    (ref_ctx,) = ref_bop._synth_ctx_cache.values()
    lrs = torch.tensor(np.asarray(ref_ctx["lrs"]))
    ref_bop._synth_ctx_cache.clear()

    fed, keys = [], {}

    def reference_draws(b, gen, deg, trans):
        seed = gen.initial_seed()
        if (deg, trans) == init_jitter:
            key = jax.random.PRNGKey(seed)
        else:
            # a run's generator splits on from its own key at each re-seed
            held = keys.setdefault(id(gen), [gen, jax.random.PRNGKey(seed)])
            held[1], key = jax.random.split(held[1])
        fed.append(((deg, trans), seed))
        return jax_jitter_draws(key, b, deg, trans)

    monkeypatch.setattr(bop, "draw_learning_rates", lambda *a, **k: lrs)
    monkeypatch.setattr(bop, "draw_pose_jitter", reference_draws)
    bop._synth_ctx_cache.clear()
    bop._synth_escalation.clear()
    got = bop._sweep_synth_objects(*args, device="cpu", **kw)
    bop._synth_ctx_cache.clear()
    # per object one init jitter, then one re-seed from its own restart key
    assert [d for d, _ in fed] == [init_jitter, restart_jitter] * 2
    assert len({s for _, s in fed}) == 4
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
        for key in ("scene", "frame", "i_obj", "obj_id", "best_step", "best_hyp"):
            assert g[key] == w[key], key
        for key in ("add_init", "adds_init", "diameter"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)
        for key in ("final_loss", "add", "adds"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)


def test_torch_tile_cap_and_probe_poses():
    """The per-tile cap, chunk-aligned, raising by name past the table's
    int32 slot ids; the probe's poses are the reference's draw."""
    from diffdope_tpu_torch import bop

    assert bop.tile_cap(1.0, (160, 160)) == 1024
    assert bop.tile_cap(1.5, (160, 160)) == 1536
    assert bop.tile_cap(1.7, (160, 160)) % 32 == 0 and bop.tile_cap(1.7, (160, 160)) >= 1740
    with pytest.raises(ValueError, match="max_tris_per_tile"):
        bop.tile_cap(2.0 ** 20, (1080, 1920))
    qs, ts = bop.probe_poses(0.2)
    prng = np.random.default_rng(0)
    want = prng.normal(size=(16, 4)).astype(np.float32)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(qs[1:], want[1:])
    np.testing.assert_array_equal(qs[0], [0, 0, 0, 1])
    assert list(ts[:, 2]) == [-2.0] * 8 + [np.float32(-1.8)] * 8


def _fake_worker(calls):
    def fake(objs, level, scene_id, frame, *a, **k):
        calls.append((level, scene_id, frame, len(objs)))
        rng = np.random.default_rng(len(calls))
        return [{"scene": scene_id, "frame": frame, "i_obj": i,
                 "obj_id": int(o.get("obj_id", -1)),
                 "add": float(rng.uniform(0.001, 0.15)),
                 "adds": float(rng.uniform(0.001, 0.15)),
                 "add_init": float(rng.uniform(0.01, 0.2)),
                 "diameter": float(rng.uniform(0.5, 1.5)), "final_loss": 0.1}
                for i, o in enumerate(objs)]
    return fake


def test_torch_sweep_aggregation_equals_reference(tmp_path, monkeypatch, stand_in):
    from diffdope_tpu import bop as ref_bop

    from diffdope_tpu_torch import bop

    root = _write_tree(tmp_path / "data", ["val/000001", "val/000002", "test/000003"],
                       ["deg_001_trans_001", "deg_040_trans_016"], n_obj=3,
                       frames=("0", "2", "10"))
    calls_ref, calls_port = [], []
    monkeypatch.setattr(ref_bop, "_sweep_synth_objects", _fake_worker(calls_ref))
    monkeypatch.setattr(bop, "_sweep_synth_objects", _fake_worker(calls_port))
    kw = dict(dataset="hope", levels=["deg_001_trans_001", "deg_040_trans_016"],
              max_scenes=2, max_frames=2, max_objects=2, log_fn=lambda *a: None)
    want = ref_bop.sweep_perturbation_levels(data_root=str(root), **kw)
    got = bop.sweep_perturbation_levels(str(root), mesh_path=str(stand_in), **kw)
    assert calls_port == calls_ref and len(calls_ref) == 8
    assert got == want
    for r in got.values():
        assert r["mode"] == "synthesized" and r["n"] == 8
        assert 0.0 < r["acc_01d"] < 1.0 and r["acc_01d_init"] is not None
    # the real branch needs no stand-in; the synthesized one does
    with pytest.raises(ValueError, match="mesh_path"):
        bop.sweep_perturbation_levels(str(root), **kw)


def test_torch_find_error_scenes_and_shards(tmp_path, monkeypatch, stand_in):
    from diffdope_tpu import bop as ref_bop

    from diffdope_tpu_torch import bop

    scenes = ["test/000048", "test/000049", "val/000001", "val/000002", "val/000007"]
    root = _write_tree(tmp_path / "data", scenes, ["deg_010_trans_004"])
    (root / "hope" / "val" / "notes.txt").write_text("not a scene")
    (root / "hope" / "README").write_text("not a split")
    (root / "hope" / "val" / "000009").mkdir()  # a scene without JSONs
    got = bop.find_error_scenes(root, "hope")
    assert got == ref_bop.find_error_scenes(root, "hope")
    assert [s for s, _ in got] == scenes
    assert all(set(lv) == {"deg_010_trans_004"} for _, lv in got)
    for n in (2, 3):
        parts = [{s for s, _ in got[i::n]} for i in range(n)]
        assert set().union(*parts) == set(scenes)
        assert sum(len(p) for p in parts) == len(scenes)
        for i in range(n):
            calls_ref, calls_port = [], []
            monkeypatch.setattr(ref_bop, "_sweep_synth_objects", _fake_worker(calls_ref))
            monkeypatch.setattr(bop, "_sweep_synth_objects", _fake_worker(calls_port))
            kw = dict(dataset="hope", levels=["deg_010_trans_004"], max_scenes=10,
                      shard=(i, n), log_fn=lambda *a: None)
            want = ref_bop.sweep_perturbation_levels(data_root=str(root), **kw)
            got_i = bop.sweep_perturbation_levels(str(root), mesh_path=str(stand_in), **kw)
            assert got_i == want and calls_port == calls_ref
            assert {c[1] for c in calls_port} == parts[i]
    with pytest.raises(FileNotFoundError):
        bop.sweep_perturbation_levels(str(root), dataset="hope", shard=(9, 10),
                                      mesh_path=str(stand_in))


def test_torch_synth_overflow_recovery(monkeypatch):
    """On '_bin_overflow' the worker grows the capacity, re-runs the same
    object and keeps the escalation for the next object; a crop leak sets
    roi_crop 'off' the same way (a per-call ground truth has no crop, so
    only a fake context can leak)."""
    from diffdope_tpu_torch import bop
    from diffdope_tpu_torch.optimize import RefineResult

    used = []

    def fake_ctx(mesh_path, resolution, batchsize, nb_iterations, obj_scale,
                 seed, optimizer="adam", base_lr=0.02, lr_bounds=(0.5, 4.0),
                 loss_weights=(0.7, 0.0, 1.0), init_jitter=(0.0, 0.0),
                 capacity_boost=1.0, roi_crop="auto", probe_dz=0.2, device="cuda"):
        steps = nb_iterations + 1

        def run(p0, gt=None, learning_rates=None):
            used.append((capacity_boost, roi_crop))
            over = np.zeros(steps, np.int32)
            leak = np.zeros(steps, np.int32)
            if capacity_boost == 1.0:
                over[-1] = 123
            if roi_crop != "off":
                leak[0] = 7
            return RefineResult(
                params=dict(p0),
                mtx_history=torch.eye(4).expand(steps, batchsize, 4, 4),
                losses_values={"total": torch.ones((steps, batchsize))},
                total_loss=torch.ones(steps),
                telemetry={"_bin_overflow": over, "_crop_leak": leak},
            )

        return dict(
            gt_render=lambda q, t: ({"rgb": np.zeros((4, 4, 3), np.float32),
                                     "segmentation": np.zeros((4, 4, 3), np.float32),
                                     "depth": np.zeros((4, 4), np.float32)},
                                    torch.eye(4)),
            pose_params=lambda q, t, b: {"q": np.tile(q, (b, 1)), "t": np.tile(t, (b, 1))},
            jitter=None, refine=run, argmin_sb=lambda losses, rule: (0, 0),
            score=lambda m_est, m_gt: (0.01, 0.01), init_mtx=lambda q, t: torch.eye(4),
            diameter=1.0, lrs=torch.ones(batchsize), weights={"total": 1.0},
        )

    monkeypatch.setattr(bop, "_synth_context", fake_ctx)
    bop._synth_escalation.clear()
    objs = [{"cam_R_m2c": np.eye(3).ravel().tolist(), "obj_id": 1},
            {"cam_R_m2c": np.eye(3).ravel().tolist(), "obj_id": 2}]
    out = bop._sweep_synth_objects(objs, "deg_040_trans_016", "s", "0", "fake.ply", 0.01,
                                   (4, 4), 2, 3, 0, lambda *a: None, device="cpu")
    assert len(out) == 2
    assert used[0] == (1.0, "auto")
    # 123 dropped pairs: the boost is max(1.5, 1 + 123 / 1024) = 1.5
    assert used[1] == (1.5, "off") and used[-1] == (1.5, "off")
    assert len(used) == 3  # one re-run for object 0, none for object 1
    esc = next(iter(bop._synth_escalation.values()))
    assert esc == {"boost": 1.5, "roi_crop": "off"}
    assert all(not any(k.endswith("_max") for k in e) for e in out)
    bop._synth_escalation.clear()
