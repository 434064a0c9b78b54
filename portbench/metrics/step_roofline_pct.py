"""The whole step's least time (``roofline.step``: both jobs' operations and
the optimizer's, the step's own inputs and outputs, at the chip's published
peaks) over the traced window's wall time per step, in %."""

from portbench import roofline

LAYER = "whole step"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    if run.trace is None or not run.steps:
        return None
    least = roofline.least_seconds(roofline.step(run.work), run.device)
    return None if least is None else 100.0 * least * run.steps / run.trace.window_s
