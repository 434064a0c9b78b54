"""The comparison that decides ``correct`` fails what it must: a run of the
harness past its look for a card, on the CPU at a tiny size, with the
program broken underneath in each way a cell can break, and the control
(the reference in bfloat16 in the program's place).  A sound run of the
same size is correct.  The faults are those of ``portbench.faults``.

The limits here are the tiny sizes' own (on the CPU the program's plain
versions read the reference's numbers bit for bit or nearly); the cells'
limits are in ``portbench/limits/`` and come from the card."""

import numpy as np
import pytest
import torch

from portbench import check, faults, run
from portbench.entries import ref_mesh_of
from portbench.tests.conftest import tiny_plan

LIMITS = {"loss_gap": 0.03, "pose_gap": 0.03, "kept_gap": 0.03}
CELLS = [("tiny-ico", "near"), ("tiny-dd", "frames")]


def _run(cell):
    return run.run_cell(tiny_plan(*cell, limits=LIMITS), 11, 0, False, device="cpu",
                        window_requests=1, checked=1)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["rows"]
    assert not out["errors"]


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_a_broken_program_is_not_correct(cell, fault):
    with faults.planted(fault):
        out = _run(cell)
    assert not out["correct"], out["rows"]


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_the_control_fails(cell):
    """The reference in bfloat16 in the program's place exceeds a limit."""
    out = _run(cell)
    low = ref_mesh_of(out["problem"], "cpu", torch.bfloat16)
    gaps = check.control(out["problem"], out["mesh"], out["proj"], low,
                         out["proj"].to(torch.bfloat16), out["frames"], out["items"],
                         np.random.default_rng(3))
    correct, rows = check.verdict(gaps, LIMITS)
    assert not correct, rows
