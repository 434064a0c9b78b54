"""The raster job's least time (``roofline.raster``: its bytes and operations
counted from the frame, the mesh and the batch, at the chip's published
peaks) over the device time of the kernels that do it (the pack K1/K2 and
the compact raster K3/K4), per step of the traced window, in %."""

from portbench import roofline
from portbench.metrics._kernels import RASTER

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    if run.trace is None or not run.steps:
        return None
    least = roofline.least_seconds(roofline.raster(run.work), run.device)
    spent = run.trace.time_of(RASTER) / run.steps
    return None if least is None or spent <= 0 else 100.0 * least / spent
