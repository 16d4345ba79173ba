"""The port's derived science: ``derived_quantities``, the fitters'
``get_derived_params`` and ``print_summary``, ``simulation.
calculate_random_models`` and the labeled matrices of ``matrix.py``.

- Twins of ``tests/test_derived_l6.py``'s ``test_derived_b1913_gr``,
  ``test_derived_mass_functions``, ``test_derived_p_f_roundtrip`` and
  ``test_fitter_get_derived_params``.
- ``print_summary`` string for string the reference's on the same model:
  the reference fits, the port commits the reference's fitted deltas and
  uncertainties into the same state (bench.py's pulsar by GLSFitter, its
  angles in H:M:S and D:M:S; an ELL1 pulsar by WLSFitter, TASC free).
- ``calculate_random_models`` from a shared numpy rng and the reference's
  covariance: every residual within 1e-12 s of the reference's.
- Twins of ``tests/test_matrix_minimize_sim.py``'s DesignMatrix and
  CovarianceMatrix tests (lines 17-113).

The reference runs once for the module in a subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch import derived_quantities as dq  # noqa: E402
from pint_tpu_torch.constants import SECS_PER_DAY  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import (  # noqa: E402
    GLSFitter,
    WidebandTOAFitter,
    WLSFitter,
    auto_fitter,
)
from pint_tpu_torch.matrix import CovarianceMatrix, DesignMatrix  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    calculate_random_models,
    make_test_pulsar,
)

PAR = """PSR J1744-1134
F0 245.4261196898081 1
F1 -5.38e-16 1
PEPOCH 55000
DM 3.1380 1
"""
ELL1_PAR = (
    "PSR JELL\nF0 100.0 1\nF1 -1e-15 1\nPEPOCH 55000\nDM 10.0 1\n"
    "BINARY ELL1\nPB 1.2 1\nA1 3.4 1\nTASC 55000.1 1\n"
    "EPS1 1e-5 1\nEPS2 2e-5 1\n"
)

_SCRIPT = textwrap.dedent(f"""
import bench
from pint_tpu.fitting import GLSFitter, WLSFitter
from pint_tpu.simulation import calculate_random_models, make_test_pulsar

def fit_and_capture(name, f, **kw):
    got = {{}}
    commit = f.cm.commit

    def capture(x, uncertainties=None):
        got["x"], got["unc"] = np.asarray(x), np.asarray(uncertainties)
        return commit(x, uncertainties=uncertainties)

    f.cm.commit = capture
    f.fit_toas(**kw)
    OUT[f"{{name}}/x"], OUT[f"{{name}}/unc"] = got["x"], got["unc"]
    OUT[f"{{name}}/chi2"] = np.array(f.chi2)
    OUT[f"{{name}}/converged"] = np.array(f.converged)
    OUT[f"{{name}}/cov"] = f.parameter_covariance_matrix
    OUT[f"{{name}}/text"] = np.array(f.print_summary())
    OUT[f"{{name}}/random"] = calculate_random_models(
        f, 20, np.random.default_rng(3))

model, toas, cm = bench._build(256)
export_state(cm, "bench")
fit_and_capture("bench", GLSFitter(toas, model, fused=False), maxiter=2)

m, toas = make_test_pulsar({ELL1_PAR!r}, ntoa=120, seed=2)
export_state(m.compile(toas), "ell1")
fit_and_capture("ell1", WLSFitter(toas, m))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "derived.npz")


def _committed(ref, name, cls):
    """A port fitter on the reference's state with the reference's fitted
    deltas, uncertainties, chi2 and covariance committed, as after a
    fit."""
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    f = cls(bundle, model, device="cpu")
    f.cm.commit(ref[f"{name}/x"], uncertainties=ref[f"{name}/unc"])
    f.chi2 = float(ref[f"{name}/chi2"])
    f.converged = bool(ref[f"{name}/converged"])
    f.parameter_covariance_matrix = ref[f"{name}/cov"]
    return f


# -- derived quantities ---------------------------------------------------
def test_derived_b1913_gr():
    """B1913+16: Pb=0.322997448918 d, e=0.6171340, mp=1.438, mc=1.390
    -> omdot ~ 4.2266 deg/yr, gamma ~ 4.30 ms, pbdot ~ -2.40e-12."""
    pb = 0.322997448918 * SECS_PER_DAY
    e = 0.6171340
    mp, mc = 1.438, 1.390
    assert dq.omdot(mp, mc, pb, e) == pytest.approx(4.2266, rel=2e-3)
    assert dq.gamma(mp, mc, pb, e) == pytest.approx(4.30e-3, rel=2e-2)
    assert dq.pbdot(mp, mc, pb, e) == pytest.approx(-2.40e-12, rel=2e-2)


def test_derived_mass_functions():
    # J1909-3744-like: Pb=1.533449 d, x=1.89799 ls -> f ~ 0.00312 Msun
    pb = 1.533449 * SECS_PER_DAY
    mf = dq.mass_funct(pb, 1.89799)
    assert mf == pytest.approx(3.12e-3, rel=1e-2)
    # invert for companion mass and check round trip
    mc = dq.companion_mass(pb, 1.89799, inc_rad=np.deg2rad(86.4), mp=1.45)
    assert dq.mass_funct2(1.45, mc, np.deg2rad(86.4)) == pytest.approx(
        mf, rel=1e-10
    )


def test_derived_p_f_roundtrip():
    f, fd = dq.p_to_f(0.1, 1e-18)
    p, pd = dq.p_to_f(f, fd)  # involution
    assert p == pytest.approx(0.1, rel=1e-14)
    assert pd == pytest.approx(1e-18, rel=1e-12)
    assert dq.pulsar_age(10.0, -1e-15) == pytest.approx(
        10.0 / (2 * 1e-15) / 3.15576e7, rel=1e-3
    )


def test_fitter_get_derived_params():
    """Fitter.get_derived_params gives the spin and binary derived
    quantities of the fitted model."""
    par = (
        "PSR JD\nF0 100.0 1\nF1 -1e-15 1\nPEPOCH 55000\nDM 10.0\n"
        "BINARY ELL1\nPB 1.2\nA1 3.4\nTASC 55000.1\n"
        "EPS1 1e-5\nEPS2 2e-5\n"
    )
    m, toas = make_test_pulsar(par, ntoa=60, seed=2, device="cpu")
    f = auto_fitter(toas, m, downhill=False, device="cpu")
    out = f.get_derived_params()
    assert "P0 = 0.01" in out
    assert "tau_c" in out and "B_surf" in out
    assert "mass function" in out


@pytest.mark.parametrize("name, cls", [("bench", GLSFitter),
                                       ("ell1", WLSFitter)])
def test_print_summary_string_equals_reference(ref, name, cls, capsys):
    """print_summary of the same committed fit is the reference's text
    string for string (values, uncertainties, angles, dof, weighted RMS,
    derived parameters), and is printed."""
    f = _committed(ref, name, cls)
    text = f.print_summary()
    assert text == str(ref[f"{name}/text"])
    assert capsys.readouterr().out.strip() == text.strip()


@pytest.mark.parametrize("name, cls", [("bench", GLSFitter),
                                       ("ell1", WLSFitter)])
def test_calculate_random_models_matches_reference(ref, name, cls):
    """20 draws from the reference's covariance with the same numpy rng:
    every residual within 1e-12 s of the reference's (the residuals of
    bench.py's pulsar, whose orbit is outside its simulated phases, reach
    milliseconds)."""
    f = _committed(ref, name, cls)
    got = calculate_random_models(f, 20, np.random.default_rng(3))
    want = ref[f"{name}/random"]
    assert got.shape == want.shape == (20, f.cm.bundle.ntoa)
    assert np.max(np.abs(got - want)) <= 1e-12
    with pytest.raises(ValueError, match="fit first"):
        g = cls(f.toas, f.model, device="cpu")
        calculate_random_models(g, 2)


# -- labeled matrices -----------------------------------------------------
def test_design_matrix_labels_and_blocks():
    m, toas = make_test_pulsar(PAR, ntoa=40, device="cpu")
    f = WLSFitter(toas, m, device="cpu")
    dm = DesignMatrix.from_fitter(f)
    assert dm.params[0] == "Offset"
    assert set(dm.params[1:]) == {"F0", "F1", "DM"}
    assert dm.shape == (40, 4)
    np.testing.assert_array_equal(dm.column("Offset"), 1.0)
    assert dm.block("toa").shape == (40, 4)
    f.fit_toas()
    cov = CovarianceMatrix.from_fitter(f)
    assert cov.sigma("F0") == pytest.approx(
        m.params["F0"].uncertainty, rel=1e-9
    )
    corr = cov.correlation()
    np.testing.assert_allclose(np.diag(corr), 1.0)


def test_design_matrix_from_wideband_fitter():
    m, toas = make_test_pulsar(PAR, ntoa=30, dm_error=1e-4, device="cpu")
    wb = WidebandTOAFitter(toas, get_model(PAR), device="cpu")
    dm = DesignMatrix.from_fitter(wb)
    assert dm.shape == (60, 4)  # Offset + F0/F1/DM over [TOA; DM] rows
    assert dm.block("dm").shape == (30, 4)
    # the DM block's DM column is -1 (d(meas - model)/dDM)
    np.testing.assert_allclose(
        dm.block("dm")[:, dm.params.index("DM")], -1.0, atol=1e-12
    )


def test_design_matrix_combine_by_quantity():
    a = DesignMatrix(np.ones((3, 2)), ["F0", "DM"])
    b = DesignMatrix(2 * np.ones((2, 2)), ["DM", "PX"],
                     [("dm", 0, 2)])
    c = a.combine_by_quantity(b)
    assert c.params == ["F0", "DM", "PX"]
    assert c.shape == (5, 3)
    np.testing.assert_array_equal(c.column("PX")[:3], 0.0)
    np.testing.assert_array_equal(c.column("F0")[3:], 0.0)
    assert c.block("dm").shape == (2, 3)
    rows, cols = c.labels()
    assert cols == ("F0", "DM", "PX")
    assert [r[0] for r in rows] == ["toa", "dm"]


def test_design_matrix_combine_by_param():
    a = DesignMatrix(np.ones((4, 2)), ["F0", "F1"])
    b = DesignMatrix(3 * np.ones((4, 1)), ["DM"])
    c = a.combine_by_param(b)
    assert c.params == ["F0", "F1", "DM"]
    assert c.shape == (4, 3)
    np.testing.assert_array_equal(c.column("DM"), 3.0)
    with pytest.raises(ValueError, match="row mismatch"):
        a.combine_by_param(DesignMatrix(np.ones((3, 1)), ["PX"]))
    with pytest.raises(ValueError, match="duplicate"):
        a.combine_by_param(DesignMatrix(np.ones((4, 1)), ["F0"]))
    sel = c.select_params(["DM", "F0"])
    assert sel.params == ["DM", "F0"]
    np.testing.assert_array_equal(sel.matrix[:, 0], 3.0)


def test_covariance_submatrix_and_blockdiag():
    c1 = CovarianceMatrix(np.array([[4.0, 1.0], [1.0, 9.0]]),
                          ["F0", "F1"])
    sub = c1.submatrix(["F1"])
    assert sub.matrix.shape == (1, 1) and sub.matrix[0, 0] == 9.0
    c2 = CovarianceMatrix(np.array([[16.0]]), ["DM"])
    big = c1.combine_block_diag(c2)
    assert big.params == ["F0", "F1", "DM"]
    assert big.sigma("DM") == 4.0
    assert big.matrix[0, 2] == 0.0
