"""The loss job's least time (``roofline.loss``: shade, antialias and L1,
forward and backward, counted from the frame, the mesh and the batch, at
the chip's published peaks) over the device time of the kernels that do it
(K5, its reduction, K6), per step of the traced window, in %."""

from portbench import roofline
from portbench.metrics._kernels import LOSS

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    if run.trace is None or not run.steps:
        return None
    least = roofline.least_seconds(roofline.loss(run.work), run.device)
    spent = run.trace.time_of(LOSS) / run.steps
    return None if least is None or spent <= 0 else 100.0 * least / spent
