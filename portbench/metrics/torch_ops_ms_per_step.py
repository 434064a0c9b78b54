"""Device time of every operation that is not one of the program's
hand-written kernels (``_kernels.ALL``: the torch ops of the render
pipeline's set-up, the optimizer's elementwise ops, copies and fills), per
refinement step of the traced window, in ms."""

from portbench.metrics._kernels import ALL

LAYER = "render.pipeline torch ops"
SOURCE = "device_trace"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    if run.trace is None or not run.steps:
        return None
    total = sum(run.trace.device_s.values())
    return 1e3 * (total - run.trace.time_of(ALL)) / run.steps
