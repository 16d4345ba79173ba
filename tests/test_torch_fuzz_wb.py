"""The port's wideband fits on the fuzz oracles' wideband compositions.

Every cached case of ``tests/test_oracle_fuzz.py::
test_oracle_fuzz_wideband_fit`` (seeds 2604-9203, one a seed): a random
composition with DM measurements on every TOA (golden17's recipe), a
free DMJUMP and random DMEFAC/DMEQUAD, drawn and ingested by the JAX
package in one reference subprocess (``tests/torch_fuzz.py``) and carried
across as its state, its DM measurements included.  The port's
``WidebandTOAFitter`` fits it with ``fit_toas(maxiter=4)`` and is held to
the committed joint [TOA; DM] mpmath fit oracle under the reference
test's ``_FIT_TOL`` (``test_oracle_fuzz.py:538-590``), with a free
DMJUMP asserted as there.
"""

import sys
import warnings
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch_fuzz  # noqa: E402
from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import WidebandTOAFitter  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_wb")
    return run_reference(torch_fuzz.reference_script("wb"), d / "ref.npz",
                         env={"FUZZ_TMP": str(d / "draws")}, timeout=900)


@pytest.mark.parametrize("seed,case", torch_fuzz.cases("wb"))
def test_fuzz_wideband_fit_matches_oracle(ref, seed, case):
    key = torch_fuzz.case_key("wb", seed, case, ref)
    model, bundle, _ = state_from_numpy(load_state(ref, key), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = WidebandTOAFitter(bundle, model, device="cpu")
        chi2 = f.fit_toas(maxiter=4)
    names = list(f.cm.free_names)
    assert any(n.startswith("DMJUMP") for n in names)
    values = dict(zip(names, ref[f"{key}/oracle/values"]))
    sigmas = dict(zip(names, ref[f"{key}/oracle/sigmas"]))
    torch_fuzz.assert_fit_parity(
        f, chi2, values, sigmas, float(ref[f"{key}/oracle/chi2"]),
        label=f"seed={seed} case={case}", **torch_fuzz.FIT_TOL)
