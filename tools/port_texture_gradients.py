"""Where the fused and the unfused route's pose gradients part at the init
of ``chip_smoke``'s exact-texture sessions, and why.

    python tools/port_texture_gradients.py [--cpu] [--resize R] [setting ...]

Each setting is a ``chip_smoke.diffdope_session`` (960x540 unless
``--resize``, B=8, the init ``chip_smoke.INIT_OFFSET`` off the configured
pose, the scene the port's render at that pose; on the card unless
``--cpu``, where every kernel wrapper takes its plain version).  At the
init it takes the pose gradients of the fused loss and of the unfused
render + losses, and prints one JSON line of gaps, each the largest
|a - b| / (1e-6 + 2e-4 |b|) (at most 1 where a and b agree at rtol 2e-4,
atol 1e-6):

- ``fused_vs_unfused``: what ``chip_smoke`` phase 14 compares;
- on the card, ``fused_repeat`` / ``unfused_repeat``: each route against
  itself, run again (order-dependent sums, atomics), and
  ``fused_k6plain_vs_unfused`` and ``fused_vs_fused_k6plain``: the fused
  route with K6 replaced by its plain twin (torch.autograd of K5's plain
  version) on the same inputs, which isolates K6's hand derivative;
- with the depth term, ``depth_ties`` (``chip_smoke.depth_ties``: pixels
  where the two routes differentiate |residual| in opposite directions)
  and ``untied_fused_vs_unfused``: the gap with the gt depth moved 1e-3
  at those pixels (``chip_smoke.untie_depth``).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

#: name: (texture kind or None for the untextured stand-in, 8-bit texture, depth term)
SETTINGS = {
    "mask_depth": (None, True, True),
    "texture_smooth": ("smooth", True, False),
    "texture_smooth_depth": ("smooth", True, True),
    "texture_smooth_f32_depth": ("smooth", False, True),
    "texture_checker": ("checker", True, False),
    "texture_checker_depth": ("checker", True, True),
}


def main() -> None:
    import argparse

    import numpy as np
    import torch

    from diffdope_tpu_torch.bench import card
    from diffdope_tpu_torch.render import fused_loss

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--resize", type=float, default=None)
    ap.add_argument("settings", nargs="*", default=list(SETTINGS))
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device (--cpu runs the plain versions)")
    label = "cpu" if args.cpu else card()
    for name in args.settings:
        kind, quantized, depth = SETTINGS[name]
        mesh = None if kind is None else chip_smoke.texture_mesh(kind, quantized)
        losses = {"l1_depth_with_mask": depth}
        tpu = {}
        if kind is not None:
            losses.update(chip_smoke.TEXTURE_LOSSES)
            tpu = chip_smoke.TEXTURE_TPU
        dd, _, _ = chip_smoke.diffdope_session(True, tpu=tpu, losses=losses, mesh=mesh,
                                               device=device, resize=args.resize)
        fused, unfused = chip_smoke.step0_grads(dd)
        out = {"setting": name, "device": label, "resolution": list(dd.resolution),
               "fused_vs_unfused": chip_smoke.grad_gap(fused, unfused)}
        if not args.cpu:  # on the CPU both routes run the plain versions
            fused2, unfused2 = chip_smoke.step0_grads(dd)
            kernel_bwd = fused_loss.loss_bwd
            fused_loss.loss_bwd = fused_loss.loss_bwd_plain
            try:
                k6plain, _ = chip_smoke.step0_grads(dd)
            finally:
                fused_loss.loss_bwd = kernel_bwd
            out.update(fused_repeat=chip_smoke.grad_gap(fused2, fused),
                       unfused_repeat=chip_smoke.grad_gap(unfused2, unfused),
                       fused_k6plain_vs_unfused=chip_smoke.grad_gap(k6plain, unfused),
                       fused_vs_fused_k6plain=chip_smoke.grad_gap(fused, k6plain))
        if depth:
            ties = chip_smoke.depth_ties(dd)
            gt = chip_smoke.untie_depth(dd, ties)
            fused_u, unfused_u = chip_smoke.step0_grads(dd, gt)
            seg = dd.gt_tensors["segmentation"][..., 0] > 0
            out.update(depth_ties=int(ties.sum()), gt_seg_pixels=int(seg.sum()),
                       untied_fused_vs_unfused=chip_smoke.grad_gap(fused_u, unfused_u))
        out["worst_key"] = max(fused, key=lambda k: chip_smoke.grad_gap(
            {k: fused[k]}, {k: unfused[k]}))
        out["fused"] = {k: np.asarray(v).tolist() for k, v in fused.items()}
        out["unfused"] = {k: np.asarray(v).tolist() for k, v in unfused.items()}
        print(json.dumps(out), flush=True)
        del dd


if __name__ == "__main__":
    main()
