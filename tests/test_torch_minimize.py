"""Parity of the port's scipy minimizers with the JAX package.

``fitting/minimize.py``: ``PowellFitter`` and ``MinimizeFitter`` with a
gradient method (BFGS, derivatives from ``torch.func.jacfwd``) on a
small white pulsar from its simulated values, against
the reference's ``MinimizeFitter`` on the same state (carried across
with ``pint_tpu_torch.convert.state_from_numpy``), and against the WLS
fit.  Tolerances are stated per test.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.exceptions import CorrelatedErrors  # noqa: E402
from pint_tpu_torch.fitting import (  # noqa: E402
    MinimizeFitter,
    PowellFitter,
    WLSFitter,
)
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

PAR = """
PSR              J0101+0101
F0               {f0}  1
F1               -1.2e-15  1
PEPOCH           55000
DM               {dm}  1
EFAC             -f L-wide 1.1
"""
TRUE = PAR.format(f0="218.81184", dm="15.99")
#: the fits start from the simulated values; Powell, derivative-free in
#: internal units, fits F0 alone (the reference's own test does so too:
#: with every parameter free its line searches wander to a huge F0)
START = TRUE
METHODS = ("Powell", "BFGS")
FROZEN = {"Powell": ("F1", "DM"), "BFGS": ()}

_SCRIPT = textwrap.dedent(f"""
from pint_tpu.fitting.minimize import MinimizeFitter
from pint_tpu.models.builder import get_model
from pint_tpu.simulation import make_test_pulsar

_, toas = make_test_pulsar({TRUE!r}, ntoa=48, seed=3,
                           freqs=(1400.0, 800.0))
for method, frozen in {FROZEN!r}.items():
    model = get_model({START!r})
    for n in frozen:
        model.params[n].frozen = True
    export_state(model.compile(toas), method)
    f = MinimizeFitter(toas, model, method=method)
    OUT[f"{{method}}/chi2"] = np.asarray(f.fit_toas())
    OUT[f"{{method}}/converged"] = np.asarray(f.converged)
    for n in f.cm.free_names:
        v = model.params[n].value
        OUT[f"{{method}}/value/{{n}}"] = np.asarray(
            float(v.to_float()) if hasattr(v, "to_float") else float(v))
        OUT[f"{{method}}/unc/{{n}}"] = np.asarray(model.params[n].uncertainty)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("minimize")
    return run_reference(_SCRIPT, d / "min.npz", timeout=600)


def _value(p):
    v = p.value
    return float(v.to_float()) if hasattr(v, "to_float") else float(v)


def _fit(ref, state, cls, **kw):
    model, bundle, _ = state_from_numpy(load_state(ref, state),
                                        device="cpu")
    f = cls(bundle, model, device="cpu", **kw)
    return f, f.fit_toas()


@pytest.mark.parametrize("method", METHODS)
def test_minimize_matches_reference(ref, method):
    """Each method from the same start: scipy's verdict the reference's,
    chi2 within 1e-8 relative of the reference's, every fitted value
    within 1e-3 of the reference's uncertainty, uncertainties (the WLS
    covariance at the optimum) within 1e-6 relative."""
    cls, kw = ((PowellFitter, {}) if method == "Powell"
               else (MinimizeFitter, {"method": method}))
    f, chi2 = _fit(ref, method, cls, **kw)
    assert f.converged == bool(ref[f"{method}/converged"])
    assert chi2 == pytest.approx(float(ref[f"{method}/chi2"]), rel=1e-8)
    for n in f.cm.free_names:
        unc = float(ref[f"{method}/unc/{n}"])
        assert abs(_value(f.model.params[n])
                   - float(ref[f"{method}/value/{n}"])) <= 1e-3 * unc, n
        assert f.model.params[n].uncertainty == pytest.approx(unc,
                                                              rel=1e-6), n


@pytest.mark.parametrize("method, chi2_rtol, sigmas", [
    ("BFGS", 1e-6, 0.05),
    # the reference's own test's criterion: L-BFGS-B's default tolerances
    # stop it short of the optimum in internal units
    ("L-BFGS-B", None, 3.0),
])
def test_gradient_methods_land_on_wls(ref, method, chi2_rtol, sigmas):
    """The gradient methods (exact jacfwd derivatives) reach the WLS
    optimum from the same start: BFGS's chi2 within 1e-6 relative and
    every value within 0.05 of its uncertainty; L-BFGS-B's values within
    3 sigma, as the reference's test_minimize_fitter_matches_wls asks."""
    f, chi2 = _fit(ref, "BFGS", MinimizeFitter, method=method)
    w, wchi2 = _fit(ref, "BFGS", WLSFitter)
    if chi2_rtol is not None:
        assert chi2 == pytest.approx(wchi2, rel=chi2_rtol)
    for n in f.cm.free_names:
        assert abs(_value(f.model.params[n]) - _value(w.model.params[n])) \
            <= sigmas * w.model.params[n].uncertainty, n


def test_powell_recovers_f0(ref):
    """Powell on F0 alone lands within 1e-10 Hz of the simulated F0 (the
    reference's criterion; its default tolerances in internal units stop
    it short of the WLS chi2)."""
    f, _ = _fit(ref, "Powell", PowellFitter)
    assert f.cm.free_names == ["F0"]
    assert _value(f.model.params["F0"]) == pytest.approx(218.81184,
                                                          abs=1e-10)


def test_correlated_noise_is_refused():
    """A model with correlated noise has a GLS chi2: refused."""
    model, toas = make_test_pulsar(
        TRUE + "TNREDAMP -13.0\nTNREDGAM 3.0\nTNREDC 5\n", ntoa=16,
        device="cpu")
    with pytest.raises(CorrelatedErrors):
        MinimizeFitter(toas, model, device="cpu")
    with pytest.raises(CorrelatedErrors):
        PowellFitter(toas, model, device="cpu")
