"""Parity of the port's chi2 grids (``pint_tpu_torch/gridutils.py``) with
the JAX package.

- ``grid_chisq`` and ``grid_chisq_derived`` on a small ELL1 pulsar with
  Shapiro delay (M2 x SINI, and the derived (companion mass, inclination)
  coordinates), and the 1-D and 2-D spin grids of the reference test's
  pulsar, each within 1e-8 relative of the reference's chi2 on the same
  state and the same grid values.
- A grid run in chunks (the last one padded) is bitwise the grid run in
  one.
- The twin of ``tests/test_derived_l6.py::test_grid_chisq_minimum_at_truth``
  with the port's own WLS fit.

The reference runs once for the module in a subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import WLSFitter  # noqa: E402
from pint_tpu_torch.gridutils import (  # noqa: E402
    grid_chisq,
    grid_chisq_derived,
    grid_chunk,
)

ELL1_PAR = (
    "PSR JELL\nF0 100.0 1\nF1 -1e-15 1\nPEPOCH 55000\nDM 10.0 1\n"
    "BINARY ELL1\nPB 1.2 1\nA1 3.4 1\nTASC 55000.1 1\n"
    "EPS1 1e-5 1\nEPS2 2e-5 1\nM2 0.3 1\nSINI 0.95 1\n"
)
M2_SINI = {"M2": [0.25, 0.3, 0.35], "SINI": [0.93, 0.95, 0.97]}
DERIVED = ([0.28, 0.32], [70.0, 75.0, 80.0])


def _derived(mc, inc_deg):
    return {"M2": mc, "SINI": float(np.sin(np.deg2rad(inc_deg)))}


_SCRIPT = textwrap.dedent(f"""
from pint_tpu.fitting import WLSFitter
from pint_tpu.gridutils import grid_chisq, grid_chisq_derived
from pint_tpu.models.builder import get_model
from pint_tpu.simulation import make_test_pulsar
from test_derived_l6 import PAR, _toas

m, toas = make_test_pulsar({ELL1_PAR!r}, ntoa=120, seed=2)
export_state(m.compile(toas), "ell1")
OUT["ell1/chi2"] = grid_chisq(toas, m, {M2_SINI!r})

def derived(mc, inc_deg):
    return {{"M2": mc, "SINI": float(np.sin(np.deg2rad(inc_deg)))}}

grids = [np.array(g) for g in {DERIVED!r}]
OUT["ell1/derived"] = grid_chisq_derived(toas, m, ["M2", "SINI"], derived,
                                         grids)

m = get_model(PAR)
toas = _toas(m)
export_state(m.compile(toas), "spin_pre")
WLSFitter(toas, m).fit_toas()
export_state(m.compile(toas), "spin")
f0_fit = float(m.params["F0"].value.to_float())
f1_fit = float(m.params["F1"].value)
g1 = [f"{{f0_fit + d:.20f}}" for d in np.linspace(-3e-11, 3e-11, 7)]
g2 = {{"F0": [f"{{f0_fit + d:.20f}}" for d in (-2e-11, 0, 2e-11)],
      "F1": [f1_fit - 2e-19, f1_fit, f1_fit + 2e-19]}}
OUT["spin/g1"] = np.array(g1)
OUT["spin/g2_f0"] = np.array(g2["F0"])
OUT["spin/g2_f1"] = np.array(g2["F1"])
OUT["spin/chi2_1d"] = grid_chisq(toas, m, {{"F0": g1}})
OUT["spin/chi2_2d"] = grid_chisq(toas, m, g2)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT, tmp_path_factory.mktemp("ref") / "grid.npz")


def _state(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model, bundle


def test_grid_chisq_matches_reference_ell1(ref):
    """M2 x SINI with 2 refits of the other 9 free parameters: within
    1e-8 relative of the reference."""
    model, bundle = _state(ref, "ell1")
    chi2 = grid_chisq(bundle, model, M2_SINI, device="cpu")
    assert chi2.shape == (3, 3)
    np.testing.assert_allclose(chi2, ref["ell1/chi2"], rtol=1e-8, atol=0)


def test_grid_chisq_derived_matches_reference(ref):
    """The derived (companion mass, inclination) grid mapped to M2 and
    SINI on the host: within 1e-8 relative of the reference."""
    model, bundle = _state(ref, "ell1")
    chi2 = grid_chisq_derived(bundle, model, ["M2", "SINI"], _derived,
                              [np.array(g) for g in DERIVED], device="cpu")
    assert chi2.shape == (2, 3)
    np.testing.assert_allclose(chi2, ref["ell1/derived"], rtol=1e-8,
                               atol=0)


def test_grid_chisq_spin_grids_match_reference(ref):
    """The reference test's 1-D F0 and 2-D F0 x F1 grids (par strings and
    floats) on its fitted model: within 1e-8 relative."""
    model, bundle = _state(ref, "spin")
    chi2 = grid_chisq(bundle, model, {"F0": list(ref["spin/g1"])},
                      device="cpu")
    np.testing.assert_allclose(chi2, ref["spin/chi2_1d"], rtol=1e-8, atol=0)
    g2 = {"F0": list(ref["spin/g2_f0"]),
          "F1": [float(v) for v in ref["spin/g2_f1"]]}
    chi2 = grid_chisq(bundle, model, g2, device="cpu")
    np.testing.assert_allclose(chi2, ref["spin/chi2_2d"], rtol=1e-8, atol=0)


@pytest.mark.parametrize("chunk", [2, 4, 9])
def test_chunked_grid_is_bitwise_the_whole_grid(ref, chunk):
    """Chunks of 2 and 4 points (the last chunk padded) and one of all 9:
    every chi2 bitwise equal to the one-chunk grid."""
    model, bundle = _state(ref, "ell1")
    whole = grid_chisq(bundle, model, M2_SINI, device="cpu")
    assert grid_chunk(model.compile(bundle), 9) == 9  # the CPU: all at once
    got = grid_chisq(bundle, model, M2_SINI, device="cpu", chunk=chunk)
    np.testing.assert_array_equal(got, whole)


def test_grid_chisq_minimum_at_truth(ref):
    """The reference test on the port: after the port's WLS fit, the 1-D
    F0 grid's minimum is its centre, at the fit's chi2 (rel 1e-4), and
    the 2-D grid's minimum is its centre."""
    m, bundle = _state(ref, "spin_pre")
    f = WLSFitter(bundle, m, device="cpu")
    chi2_fit = f.fit_toas()
    f0_fit = float(m.params["F0"].value.to_float())
    f0_grid = [f"{f0_fit + d:.20f}" for d in np.linspace(-3e-11, 3e-11, 7)]
    chi2 = grid_chisq(bundle, m, {"F0": f0_grid}, device="cpu")
    assert chi2.shape == (7,)
    assert np.argmin(chi2) == 3  # center = fitted value
    assert chi2[3] == pytest.approx(chi2_fit, rel=1e-4)
    f1_fit = float(m.params["F1"].value)
    chi2_2d = grid_chisq(
        bundle, m,
        {
            "F0": [f"{f0_fit + d:.20f}" for d in (-2e-11, 0, 2e-11)],
            "F1": [f1_fit - 2e-19, f1_fit, f1_fit + 2e-19],
        },
        device="cpu",
    )
    assert chi2_2d.shape == (3, 3)
    assert np.unravel_index(np.argmin(chi2_2d), (3, 3)) == (1, 1)


def test_grid_refuses_frozen_and_epoch_parameters(ref):
    model, bundle = _state(ref, "ell1")
    with pytest.raises(ValueError, match="must be free"):
        grid_chisq(bundle, model, {"PEPOCH": [55000.0]}, device="cpu")


@pytest.mark.gpu
def test_grid_chunk_card_matches_cpu():
    """One grid chunk on the card (its QR route, captured as a step
    program) against the CPU's (SVD) on a 2048-TOA binary MSP copy with
    12 DMX ranges: chi2 within 1e-8 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from pint_tpu_torch.simulation import MSP_FREQS, make_test_pulsar, msp_par

    model, toas = make_test_pulsar(
        msp_par(12, seed=0), ntoa=2048, start_mjd=53000.0, end_mjd=57500.0,
        iterations=1, orbit=True, orbit_in_phase=True, freqs=MSP_FREQS,
        device="cpu")
    grid = {"M2": [0.15, 0.2, 0.25], "SINI": [0.99, 0.998]}
    got = {d: grid_chisq(toas, model, grid, device=d, chunk=6)
           for d in ("cuda", "cpu")}
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-8, atol=0)
