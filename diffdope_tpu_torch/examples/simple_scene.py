"""Refine a single object pose on the configured scene.

Counterpart of ``examples/simple_scene.py``:

    python -m diffdope_tpu_torch.examples.simple_scene [key.sub=value ...] [--device cpu]

The scene, the mesh and every setting come from ``configs/diffdope.yaml``
with hydra-style dotted overrides, e.g.

    python -m diffdope_tpu_torch.examples.simple_scene \\
        scene.path_img=rgb.png scene.path_depth=depth.png \\
        scene.path_segmentation=seg.png object3d.model_path=mesh.ply \\
        hyperparameters.nb_iterations=30 tpu.optimizer=adam

Prints the chosen hypothesis, its pose in both frames and the run's
statistics, and writes ``plot.png`` (the loss curves; needs matplotlib),
``overlay.png`` and, unless ``render_images.make_animation`` is false,
``simple_scene.mp4`` into the working directory.  The refinement runs on
the card unless ``--device`` names another.
"""

import argparse
import sys

from diffdope_tpu_torch.config import cli_overrides, load_config
from diffdope_tpu_torch.diffdope import DiffDope


def main(argv=None):
    """Run the example; returns the refined session."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    import cv2

    cfg = load_config(overrides=cli_overrides(rest))
    ddope = DiffDope(cfg=cfg, device=args.device)
    ddope.run_optimization()

    print("argmin:", ddope.get_argmin())
    print("pose (OpenGL frame):\n", ddope.get_pose())
    print("pose (OpenCV/BOP frame):\n", ddope.get_pose_opencv())
    print("run stats:", ddope.last_run_stats)

    img_plot = ddope.plot_losses()
    if img_plot is not None:
        cv2.imwrite("plot.png", img_plot)
        print("saved loss plot to plot.png")

    overlay = ddope.render_img()
    cv2.imwrite("overlay.png", overlay)
    print("saved final overlay to overlay.png")

    if cfg.get_dotted("render_images.make_animation", True):
        ddope.make_animation(output_file_path="simple_scene.mp4")
        print("saved animation to simple_scene.mp4")
    return ddope


if __name__ == "__main__":
    main()
