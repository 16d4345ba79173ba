"""The port's residuals on the fuzz oracles' compositions.

Every cached case of ``tests/test_oracle_fuzz.py::
test_oracle_fuzz_composition`` (seeds 2604-9203, five compositions a
seed): drawn and ingested by the JAX package in one reference
subprocess (``tests/torch_fuzz.py``), carried across as its state, and
held within 1 ns of the committed mpmath oracle, the reference test's
own gate (``test_oracle_fuzz.py:477``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch_fuzz  # noqa: E402
from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_res")
    return run_reference(torch_fuzz.reference_script("res"), d / "ref.npz",
                         env={"FUZZ_TMP": str(d / "draws")}, timeout=900)


@pytest.mark.parametrize("seed,case", torch_fuzz.cases("res"))
def test_fuzz_residuals_match_oracle(ref, seed, case):
    """Raw residuals (no mean subtracted) within 1e-9 s of the oracle."""
    key = torch_fuzz.case_key("res", seed, case, ref)
    model, bundle, _ = state_from_numpy(load_state(ref, key), device="cpu")
    cm = model.compile(bundle, device="cpu")
    r = cm.time_residuals(cm.x0(), subtract_mean=False).numpy()
    assert np.all(np.isfinite(r))
    np.testing.assert_allclose(
        r, ref[f"{key}/oracle/raw"], rtol=0, atol=1e-9,
        err_msg=f"seed={seed} case={case}\n{ref[key + '/par']}")
