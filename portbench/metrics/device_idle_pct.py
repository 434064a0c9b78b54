"""The share of the traced window in which no operation ran on the device
(the union of the trace's device intervals against the window), in %."""

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
