"""``DiffDope``'s own time outside its dispatch, per refinement: the
request's wall time less ``last_run_stats['wall_time_s']`` (the scene, the
ground truth to the device, the loss build and its capacity probe, the
result copies, ``get_pose``, and any re-run but the last), mean over the
window's refinements, in ms."""

LAYER = "diffdope"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["yaml-default-b8-960.frames"]


def read(run):
    host = [r.wall_s - r.program["wall_time_s"] for r in run.records
            if "wall_time_s" in r.program]
    return 1e3 * sum(host) / len(host) if host else None
