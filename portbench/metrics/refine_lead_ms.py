"""The program's lead into a refinement: from the start of its ``dd.refine``
span (the call entered) to the end of its first graph replay's launch
(``dd.refine.replay``'s ``first_launch_end_ns``), the time the device, idle
since the last pose came back, waits on the program; mean over the traced
window's refinements, in ms."""

from portbench.metrics._spans import window

LAYER = "whole step"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "refinements_per_s"
WORKLOADS = ["ico5-b64-400.near", "ico5-b64-400.far"]


def read(run):
    calls = window(run)
    if calls is None:
        return None
    leads = []
    for spans in calls:
        refine = min((s for s in spans if s.name == "dd.refine"), key=lambda s: s.start_ns,
                     default=None)
        replay = [s for s in spans if s.name == "dd.refine.replay"
                  and refine is not None and s.parent == refine.id
                  and "first_launch_end_ns" in s.attrs]
        if replay:
            leads.append(replay[0].attrs["first_launch_end_ns"] - refine.start_ns)
    return 1e-6 * sum(leads) / len(leads) if leads else None
