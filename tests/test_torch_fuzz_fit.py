"""The port's fits on the fuzz oracles' fit compositions.

Every cached case of ``tests/test_oracle_fuzz.py::test_oracle_fuzz_fit``
(seeds 2604-9203, two a seed): a random composition with a random
free-parameter subset, drawn and ingested by the JAX package in one
reference subprocess (``tests/torch_fuzz.py``) and carried across as its
state.  As in the reference test (``test_oracle_fuzz.py:507-512``), a
composition with red noise or ECORR is fitted by the port's
``GLSFitter(fused=False)``, any other by its ``WLSFitter``, with
``fit_toas(maxiter=4)``, and held to the committed mpmath fit oracle
under the reference test's ``_FIT_TOL``: values within 3e-3 sigma,
sigmas within 3e-5 and chi2 within 1e-5 relative.
"""

import sys
import warnings
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch_fuzz  # noqa: E402
from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import GLSFitter, WLSFitter  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_fit")
    return run_reference(torch_fuzz.reference_script("fit"), d / "ref.npz",
                         env={"FUZZ_TMP": str(d / "draws")}, timeout=900)


@pytest.mark.parametrize("seed,case", torch_fuzz.cases("fit"))
def test_fuzz_fit_matches_oracle(ref, seed, case):
    key = torch_fuzz.case_key("fit", seed, case, ref)
    par_text = str(ref[f"{key}/par"])
    model, bundle, _ = state_from_numpy(load_state(ref, key), device="cpu")
    correlated = ("TNREDAMP" in par_text) or ("ECORR" in par_text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if correlated:
            f = GLSFitter(bundle, model, fused=False, device="cpu")
        else:
            f = WLSFitter(bundle, model, device="cpu")
        chi2 = f.fit_toas(maxiter=4)
    names = list(f.cm.free_names)
    values = dict(zip(names, ref[f"{key}/oracle/values"]))
    sigmas = dict(zip(names, ref[f"{key}/oracle/sigmas"]))
    torch_fuzz.assert_fit_parity(
        f, chi2, values, sigmas, float(ref[f"{key}/oracle/chi2"]),
        label=f"seed={seed} case={case}", **torch_fuzz.FIT_TOL)
