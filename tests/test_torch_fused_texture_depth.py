"""Port parity for the exact-texture fused loss beyond the 8-bit texture's
route (tests/test_torch_fused_texture.py): an f32 texture, which
``make_fused_loss(tex=)`` samples by ``texture_planar`` (no packed
table), and the colour lane with the depth plane, against the JAX
make_fused_loss on the same scene.  Totals and logs rtol 1e-5, atol 1e-7;
pose gradients rtol 2e-4, atol 1e-6."""

from torch_scene import port_fused_texture_loss, scene_texture
from test_torch_fused_texture import _port_step, assert_step_matches, reference_step
from torch_scene import one_torch_thread  # noqa: F401


def test_torch_fused_texture_f32_sampler_matches_reference():
    tex = scene_texture(quantized=False)["tex"]
    fn, total, logs, grads = _port_step(tex)
    assert not fn.sample.packed
    assert_step_matches(dict(total=total, logs=logs, grads=grads), reference_step(tex))


def test_torch_fused_texture_with_depth_matches_reference():
    """The colour lane with the depth plane: the rows' z channel follows
    the uv (lanes 22-24)."""
    tex = scene_texture()["tex"]
    ref = reference_step(tex, use_depth=True)
    assert ref["logs"]["depth"].min() > 0
    _, total, logs, grads = _port_step(tex, port_fused_texture_loss(tex, use_depth=True))
    assert_step_matches(dict(total=total, logs=logs, grads=grads), ref,
                        ("rgb", "depth", "mask_selection"))
