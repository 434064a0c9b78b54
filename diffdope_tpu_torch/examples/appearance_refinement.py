"""Joint pose + appearance refinement on the configured scene.

Counterpart of ``examples/appearance_refinement.py``:
``Mesh.enable_gradients_texture()`` makes the mesh's baked per-corner
colours a refined parameter beside the pose.  They start flat grey and
are recovered together with the pose from the photo:

    python -m diffdope_tpu_torch.examples.appearance_refinement \\
        [key.sub=value ...] [--device cpu]

The mesh must be textured (its corner colours are baked from the
texture).  Defaults: a quarter-size scene, the rgb loss beside the mask,
61 Adam steps of 4 hypotheses at base lr 0.5, loss scales in [0.5, 2];
overrides as in ``simple_scene``.  Writes ``appearance_overlay.png`` (the
refined colours and pose) into the working directory.  The refinement
runs on the card unless ``--device`` names another.
"""

import argparse
import sys

import numpy as np

from diffdope_tpu_torch.config import cli_overrides, load_config
from diffdope_tpu_torch.diffdope import DiffDope

#: the JAX script's defaults, before the command line's overrides.  The
#: schedule is base_lr * 0.1 ** itf with itf in [1, 2]: the rate starts at
#: a tenth of base_lr, so the colours need a larger base than the pose
#: alone; the loss scales are narrowed so the logged loss stays readable
DEFAULTS = [
    "scene.image_resize=0.25",
    "losses.l1_rgb_with_mask=true", "losses.weight_rgb=1.0",
    "hyperparameters.nb_iterations=60", "hyperparameters.batchsize=4",
    "hyperparameters.learning_rates_bound=[0.5,2.0]",
    "tpu.optimizer=adam", "hyperparameters.base_lr=0.5",
]


def main(argv=None):
    """Run the example; returns the refined session."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    cfg = load_config(overrides=cli_overrides(DEFAULTS + rest))

    ddope = DiffDope(cfg=cfg, device=args.device)

    mesh = ddope.object3d.mesh
    if mesh.corner_colors is None:
        sys.exit("appearance_refinement needs a textured mesh (baked corner colours)")
    before = np.asarray(mesh.corner_colors).copy()
    mesh.corner_colors = np.full_like(before, 0.5)  # forget the texture
    mesh.enable_gradients_texture()

    ddope.run_optimization()

    after = np.asarray(mesh.corner_colors)
    moved = float(np.abs(after - 0.5).mean())
    best = ddope.get_argmin()
    rgb_log = ddope.losses_values["rgb"][:, best]
    print(f"run stats: {ddope.last_run_stats}")
    print(f"rgb loss (best hypothesis): {rgb_log[0]:.4f} -> {rgb_log[-1]:.4f}")
    print(f"mean |color change| from the gray init: {moved:.4f} "
          "(the mesh now holds the fitted appearance: the photo's shaded "
          "colours, not the raw albedo)")
    print(f"pose (OpenGL frame):\n{ddope.get_pose()}")

    import cv2

    cv2.imwrite("appearance_overlay.png", ddope.render_img())
    print("saved appearance_overlay.png (refined colors + pose)")
    return ddope


if __name__ == "__main__":
    main()
