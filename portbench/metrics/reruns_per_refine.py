"""Recovery re-runs a refinement took: ``DiffDope.last_run_stats
['recovery_reruns']`` summed over the window's refinements, over their
number."""

LAYER = "diffdope"
SOURCE = "program_counter"
UNIT = "count"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["yaml-default-b8-960.frames"]


def read(run):
    reruns = [r.program["recovery_reruns"] for r in run.records
              if "recovery_reruns" in r.program]
    return sum(reruns) / len(reruns) if reruns else None
