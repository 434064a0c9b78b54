"""The table stage of a refinement step on the device's clock, from the program's
device stamps (``diffdope_tpu_torch.trace``): the step's entry to its table
laid out (S1 - S0): the pose, the ground truth's planes, the corner planes,
the binning's top-k and segmented sort, the compaction; mean over the traced
window's steps, in ms."""

from portbench.metrics._spans import stage_ms

LAYER = "render.pipeline torch ops"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    return stage_ms(run, "table")
