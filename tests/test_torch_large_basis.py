"""The mixed GLS step with a noise basis of 2048 or more columns.

A NANOGrav-style pulsar with ECORR has one basis column per observing
epoch, so k passes 2048 at about 2000 epochs.  Under the refined-solve
policy (on by default on the card; forced here with
``PINT_TPU_TORCH_SOLVE_IR=force``) the port's mixed step factors the
k x k Woodbury Sigma with the native f32 Cholesky at every size, as the
preconditioner of its f64-refined solve, where the reference hands such
operands to its blocked ``fast_cholesky32`` (ROADMAP C R3).  The step is
held to the f64 step from the same x, the port's and the JAX package's
(the reference in the subprocess of tests/torch_reference.py, on the same
numpy inputs), at the reference's mixed-step gates: dx 2e-3 of the
largest component, chi2 1e-3 relative, normalized covariance 5e-3.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.fitting.base import design_with_offset  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    gls_step_woodbury,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

#: tests/test_torch_fourier.py's ECORR pulsar, every TOA under one flag
ECORR_PAR = (
    "PSR E\nF0 245.42 1\nF1 -5e-16 1\nPEPOCH 55000\nDM 3.14 1\n"
    "EFAC -f L-wide 1.2\nECORR -f L-wide 0.8\n"
    "TNREDAMP -13.0\nTNREDGAM 3.5\nTNREDC 8\n"
)
#: observing epochs of two TOAs each: 2040 ECORR columns and 16
#: red-noise columns, k = 2056
NEPOCH = 2040
#: the reference's mixed-step gates: dx, chi2, normalized covariance
GATES = (2e-3, 1e-3, 5e-3)

_SCRIPT = textwrap.dedent("""
import jax.numpy as jnp
from pint_tpu.fitting.gls import gls_step_woodbury

with np.load(INPUTS) as z:
    args = [jnp.asarray(z[name]) for name in ("r", "M", "Nd", "T", "phi")]
dx, (covn, _), chi2, _ = gls_step_woodbury(*args, normalized_cov=True)
OUT["dx"] = np.asarray(dx)
OUT["covn"] = np.asarray(covn)
OUT["chi2"] = np.asarray(chi2)
""")


def _paired_epochs(toas, dt):
    """Each TOA followed by a copy ``dt`` seconds later: one ECORR epoch
    (the gap is 10 s) of two TOAs."""
    n = len(toas["freq_mhz"])
    idx = np.repeat(np.arange(n), 2)
    out = {key: ([v[i] for i in idx] if isinstance(v, list) else v[idx])
           for key, v in toas.items()}
    out["tdb_sec_hi"] = out["tdb_sec_hi"] + np.tile([0.0, dt], n)
    return out


@pytest.fixture(scope="module")
def step_inputs():
    """(r, M, Ndiag, T, phi) of the ECORR pulsar from its par values."""
    model, toas = make_test_pulsar(ECORR_PAR, ntoa=NEPOCH, seed=7,
                                   flags=("L-wide",), device="cpu")
    # a whole number of spin periods, so the copy's residual is the
    # original's to within the F1 term (~1e-8 of a period)
    f0 = 245.42
    cm = model.compile(_paired_epochs(toas, round(3.0 * f0) / f0),
                       device="cpu")
    x0 = cm.x0()
    T, phi = cm.noise_basis_or_empty(x0)
    return (cm.time_residuals(x0, subtract_mean=False),
            design_with_offset(cm, x0), torch.square(cm.scaled_sigma(x0)),
            T, phi)


@pytest.fixture(scope="module")
def reference_step(step_inputs, tmp_path_factory):
    """The JAX package's f64 step on the same numpy inputs."""
    tmp = tmp_path_factory.mktemp("large_basis")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **dict(zip(("r", "M", "Nd", "T", "phi"),
                                (x.numpy() for x in step_inputs))))
    out = run_reference(f"INPUTS = {str(inputs)!r}\n" + _SCRIPT,
                        tmp / "ref.npz")
    return out["dx"], out["covn"], float(out["chi2"])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("anchor", ["port", "reference"])
def test_mixed_step_at_large_k_matches_f64(monkeypatch, step_inputs,
                                           request, anchor):
    """k = 2056 >= 2048: under the card's solve policy the mixed step runs
    and lands within the mixed-step gates of the f64 step, the port's and
    the reference's."""
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    assert step_inputs[3].shape[1] == NEPOCH + 16 >= 2048
    dx, (covn, _), chi2, _ = gls_step_woodbury_mixed(*step_inputs,
                                                     normalized_cov=True)
    if anchor == "port":
        wdx, (wcov, _), wchi2, _ = gls_step_woodbury(*step_inputs,
                                                     normalized_cov=True)
        want = (wdx.numpy(), wcov.numpy(), float(wchi2))
    else:
        want = request.getfixturevalue("reference_step")
    assert np.all(np.isfinite(dx.numpy()))
    assert _rel(dx, want[0]) <= GATES[0]
    assert abs(float(chi2) - want[2]) <= GATES[1] * abs(want[2])
    assert _rel(covn, want[1]) <= GATES[2]
