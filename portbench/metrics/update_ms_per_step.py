"""The update stage of a refinement step on the device's clock, from the
program's device stamps (``diffdope_tpu_torch.trace``): the gradients to the
step's end (S4 - S3): the history rows, the optimizer's update and the
counters; mean over the traced window's steps, in ms."""

from portbench.metrics._spans import stage_ms

LAYER = "render.pipeline torch ops"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    return stage_ms(run, "update")
