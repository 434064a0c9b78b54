"""CUDA graphs the program captured in the traced window (its
``dd.refine.capture`` spans) over the window's refinements: 0 while every
refinement replays the step captured in set-up."""

from portbench.metrics._spans import window

LAYER = "whole step"
SOURCE = "program_span"
UNIT = "count"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    calls = window(run)
    if calls is None:
        return None
    captures = sum(s.name == "dd.refine.capture" for spans in calls for s in spans)
    return captures / len(calls)
