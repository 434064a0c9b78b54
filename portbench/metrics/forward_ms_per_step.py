"""The forward stage of a refinement step on the device's clock, from the
program's device stamps (``diffdope_tpu_torch.trace``): the table laid out to
the objective returned (S2 - S1): the pack (K1), the raster (K3), the loss
(K5) and the loss sums; mean over the traced window's steps, in ms."""

from portbench.metrics._spans import stage_ms

LAYER = "kernels"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    return stage_ms(run, "forward")
