"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (``run_cell`` on the CPU,
at the small copy of the binary MSP with the cell's own start offsets)
and plants one fault the cell can have: a step that returns its state
unchanged, half of the TOAs left out of every step, an answer altered
where the fitter produces it, and one design column scaled by 1.1.  A cell on one card has no
exchange between cards to leave out.  A last test runs the command
itself where no card is: it must fail and print no result."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import small_config
from portbench import harness

CHECKOUT = Path(__file__).resolve().parents[2]


def _run():
    cell = harness.load_cell("msp_rn_1e5.gls")
    cell["config"] = dict(small_config("msp_rn_1e5"),
                          name="msp_rn_1e5")
    return harness.run_cell(cell, 2 ** 31 + 901, 0.5, False, device="cpu")


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def test_step_returning_its_state_unchanged(monkeypatch):
    from pint_tpu_torch.fitting.gls import GLSFitter

    real = GLSFitter._gn_step

    def unchanged(self, x, mode):
        _, cov, chi2, nbad = real(self, x, mode)
        return x, cov, chi2, nbad

    monkeypatch.setattr(GLSFitter, "_gn_step", unchanged)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["param_gap_sigma"]["value"] > \
        out["checks"]["param_gap_sigma"]["limit"]


def test_half_of_the_toas_left_out(monkeypatch):
    from pint_tpu_torch.fitting.gls import GLSFitter

    inputs, noise = GLSFitter._step_inputs, GLSFitter._step_noise
    monkeypatch.setattr(GLSFitter, "_step_inputs", lambda self, x: tuple(
        a[::2] for a in inputs(self, x)))
    monkeypatch.setattr(GLSFitter, "_step_noise", lambda self, x: (
        lambda T, phi: (T[::2], phi))(*noise(self, x)))
    out = _run()
    assert not out["correct"]
    assert out["checks"]["cov_gap"]["value"] > \
        out["checks"]["cov_gap"]["limit"]


def test_answer_altered_where_it_is_produced(monkeypatch):
    from pint_tpu_torch.fitting.base import Fitter

    real = Fitter._finalize

    def altered(self, x, cov, chi2):
        out = real(self, x, cov, chi2)
        name = self.cm.free_names[0]
        p = self.model.params[name]
        p.set_internal(p.internal() + np.sqrt(
            self.parameter_covariance_matrix[0, 0]))
        return out

    monkeypatch.setattr(Fitter, "_finalize", altered)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["param_gap_sigma"]["value"] > \
        out["checks"]["param_gap_sigma"]["limit"]


def test_design_column_scaled(monkeypatch):
    from pint_tpu_torch.fitting.gls import GLSFitter

    inputs = GLSFitter._step_inputs

    def scaled(self, x):
        r, M, ndiag = inputs(self, x)
        M = M.clone()
        M[:, 1] *= 1.1
        return r, M, ndiag

    monkeypatch.setattr(GLSFitter, "_step_inputs", scaled)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["design_gap"]["value"] > \
        out["checks"]["design_gap"]["limit"]


def test_command_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "msp_rn_1e5.gls", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
