"""The harness on the card at the tiny sizes: the program's kernels against
the plain reference, a sound run correct and the control not.  Skipped
where no card is present (decided inside the test)."""

import numpy as np
import pytest
import torch

from portbench import check, run
from portbench.entries import ref_mesh_of
from portbench.tests.conftest import tiny_plan
from portbench.tests.test_faults import CELLS, LIMITS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_card_run_is_correct_and_its_control_is_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the program's kernels run only there")
    out = run.run_cell(tiny_plan(*cell, limits=LIMITS), 13, 0, False, device="cuda",
                       window_requests=2, checked=2)
    assert out["correct"], out["rows"]
    low = ref_mesh_of(out["problem"], "cuda", torch.bfloat16)
    gaps = check.control(out["problem"], out["mesh"], out["proj"], low,
                         out["proj"].to(torch.bfloat16), out["frames"], out["items"],
                         np.random.default_rng(3))
    assert not check.verdict(gaps, LIMITS)[0], gaps
