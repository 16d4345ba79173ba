"""On the card (marked ``gpu``; each test skips without one): a run of
each cell's small copy through the harness comes out correct, its trace
holds device work, and the f32 control of the same inputs is further
from the reference than the card's fit."""

import numpy as np
import pytest

from conftest import small_cell
from portbench import harness
from portbench.compare import gaps, reference_fit

CELLS = ["msp_rn_1e5.gls", "msp_ecorr_8k.dense"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_small_copy_on_the_card(cuda, name):
    out = harness.run_cell(small_cell(name), 2 ** 31 + 33, 1.0, True,
                           device=cuda)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_control_is_further_off_than_the_card(cuda):
    from portbench.inputs.simulate import simulate, start_par

    cell = small_cell(CELLS[0])
    truth, table = simulate(cell["config"], 2 ** 31 + 34)
    par = start_par(truth, cell["start"]["offsets"], 2 ** 31 + 34)
    ref = reference_fit(par, table, cell["fitter"]["maxiter"])
    prog = harness.Program(par, table, cell, cuda)
    card = gaps(prog.answer(prog.fit()), ref)
    ctrl = gaps(reference_fit(par, table, cell["fitter"]["maxiter"],
                              dtype=np.float32), ref)
    assert ctrl["chi2_gap"] > 10 * card["chi2_gap"]
