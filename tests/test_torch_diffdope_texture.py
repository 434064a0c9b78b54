"""A textured mesh through ``DiffDope`` under ``tpu.texture_mode: baked``:
the port session built from a reference session's state (the texture,
its uv and the baked corner colours carried over by
``convert.diffdope_state``) starts where the reference starts and logs
its step 0.  Step-0 logs rtol 1e-5, atol 1e-7; initial poses rtol 1e-6."""

import numpy as np

from diffdope_tpu_torch import convert
from torch_scene import one_torch_thread  # noqa: F401


def test_torch_baked_texture_diffdope_step0_matches_reference(monkeypatch):
    """A textured mesh under texture_mode baked (its corner colours) on the
    fused route: the port session built from the reference's state
    (convert.diffdope_state: tex, uv, uv_idx and corner_colors too) has the
    reference's initial poses and step-0 logs (rtol 1e-5, atol 1e-7)."""
    import diffdope_tpu as dd
    import jax
    import jax.numpy as jnp
    from diffdope_tpu.mesh import Mesh, bake_corner_colors, build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch
    from diffdope_tpu.testing import icosphere

    from test_torch_diffdope import (
        INIT_POSITION,
        INIT_ROTATION,
        RES as D_RES,
        _camera_args,
        _cfg,
        _port_session,
    )
    from diffdope_tpu_torch.testing import quantize8, spherical_uv

    monkeypatch.setenv("DD_DROWS_BF16", "0")
    verts, faces = icosphere(2)
    uv = spherical_uv(verts)
    tex = quantize8(np.random.default_rng(4).uniform(0.1, 0.9, (16, 16, 3)))
    mesh = Mesh(pos=verts * 0.4, pos_idx=faces, vtx_normals=verts,
                num_vertices=len(verts), num_triangles=len(faces), uv=uv, uv_idx=faces,
                tex=tex, corner_colors=bake_corner_colors(tex, uv, faces),
                edge_adj=build_edge_adjacency(faces))
    camera = dd.Camera(**_camera_args())
    mtx_gt, _, _ = pose_matrix(pose_params(
        np.array([0, 0, 0, 1.0], np.float32), np.array([0.05, 0.0, -3.0], np.float32), 1))
    gtr = jax.jit(lambda m: render_batch(
        jnp.asarray(camera.cam_proj), m, jnp.asarray(mesh.pos), jnp.asarray(mesh.pos_idx),
        D_RES, corner_colors=jnp.asarray(mesh.corner_colors),
        edge_adj=jnp.asarray(mesh.edge_adj), raster_impl="pallas", max_tris_per_tile=512,
    ))(mtx_gt)
    scene = dd.Scene(tensor_rgb=dd.Image(img_tensor=np.asarray(gtr["rgb"][0])),
                     tensor_segmentation=dd.Image(img_tensor=np.asarray(gtr["mask"][0])))
    cfg = _cfg("sgd")
    cfg["hyperparameters"]["nb_iterations"] = 0
    obj = dd.Object3D(position=INIT_POSITION, rotation=INIT_ROTATION,
                      batchsize=cfg["hyperparameters"]["batchsize"], mesh=mesh)
    ref = dd.DiffDope(cfg=dd.ConfigNode(cfg), camera=camera, object3d=obj, scene=scene)
    ref.run_optimization()

    state = convert.diffdope_state(ref)
    assert "vtx_color" not in state
    for key in ("tex", "uv", "uv_idx", "corner_colors"):
        np.testing.assert_array_equal(state[key], getattr(mesh, key), err_msg=key)
    port = _port_session(state, cfg)
    assert port.object3d.mesh.has_textured_map
    assert "corner_colors" in port._mesh_arrays() and "tex" not in port._mesh_arrays()
    port.run_optimization()
    np.testing.assert_allclose(port.mtx_history[0], np.asarray(ref.mtx_history[0]),
                               rtol=1e-6, atol=1e-7)
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(port.losses_values[k][0], np.asarray(v)[0], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
