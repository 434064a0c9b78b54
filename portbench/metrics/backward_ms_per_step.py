"""The backward stage of a refinement step on the device's clock, from the
program's device stamps (``diffdope_tpu_torch.trace``): the objective to the
gradients returned (S3 - S2): K6, K4, K2 and autograd's own operations; mean
over the traced window's steps, in ms."""

from portbench.metrics._spans import stage_ms

LAYER = "kernels"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    return stage_ms(run, "backward")
