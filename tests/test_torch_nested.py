"""The port's nested sampler (``pint_tpu_torch/nested.py``) against the
JAX package's (``pint_tpu/nested.py``).

Twins of ``tests/test_nested.py``'s five tests at the reference's gates.
Where the likelihood is numpy (the analytic, bimodal and unimodal cases)
the port's run is also the reference's draw for draw: evidence, dead
points and equal-weight samples bitwise equal, the reference's runs made
once for the module in a subprocess (tests/torch_reference.py).  The
golden1 posterior runs ``BayesianTiming.sample_nested`` on the port's own
GLS fit of the reference's ingested state, its vmapped likelihood one
step program of the proposal batch's length.
"""

import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.bayesian import BayesianTiming  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import GLSFitter  # noqa: E402
from pint_tpu_torch.models.priors import UniformBoundedRV  # noqa: E402
from pint_tpu_torch.nested import (  # noqa: E402
    nested_checkpoint_state,
    nested_init,
    nested_iterate,
    nested_restore_state,
    nested_result,
    nested_sample,
)

MU, S, D = 0.5, 0.15, 3


def _gauss_loglike(X):
    lognorm = -0.5 * D * np.log(2 * np.pi * S * S)
    X = np.atleast_2d(X)
    return lognorm - 0.5 * np.sum(((X - MU) / S) ** 2, axis=1)


def _bimodal_loglike(s=0.003):
    """Two well-separated narrow Gaussians in the unit square; each
    integrates to ~1 over the cube, weights 0.5 -> Z ~ 1, logZ ~ 0."""
    mus = np.array([[0.15, 0.15], [0.85, 0.85]])

    def ll(X):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        d0 = ((X - mus[0]) ** 2).sum(axis=1)
        d1 = ((X - mus[1]) ** 2).sum(axis=1)
        a = -d0 / (2 * s * s) - np.log(2 * np.pi * s * s) + np.log(0.5)
        b = -d1 / (2 * s * s) - np.log(2 * np.pi * s * s) + np.log(0.5)
        return np.logaddexp(a, b)

    return ll


def _unit(c):
    return np.asarray(c, dtype=np.float64)


_SCRIPT = textwrap.dedent("""
import warnings
from pint_tpu.models.builder import get_model_and_toas
from pint_tpu.nested import nested_sample
from test_nested import _bimodal_loglike

mu, s, d = 0.5, 0.15, 3
lognorm = -0.5 * d * np.log(2 * np.pi * s * s)

def loglike(X):
    X = np.atleast_2d(X)
    return lognorm - 0.5 * np.sum(((X - mu) / s) ** 2, axis=1)

unit = lambda c: np.asarray(c, dtype=np.float64)
runs = {
    "analytic": (loglike, d, dict(nlive=300, dlogz=0.05, seed=3)),
    "bimodal": (_bimodal_loglike(), 2, dict(nlive=200, seed=1,
                                            method="multi")),
    "unimodal_multi": (loglike, d, dict(nlive=200, seed=5,
                                        method="multi")),
    "unimodal_single": (loglike, d, dict(nlive=200, seed=5,
                                         method="single")),
}
for name, (ll, nd, kw) in runs.items():
    res = nested_sample(ll, unit, nd, **kw)
    for k in ("logz", "logzerr", "niter", "ncall", "nells", "samples",
              "samples_raw", "logwt"):
        OUT[f"{name}/{k}"] = np.asarray(res[k])

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    gm, gt = get_model_and_toas("tests/datafile/golden1.par",
                                "tests/datafile/golden1.tim")
export_state(gm.compile(gt), "golden1")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "nested.npz")


def _same_as_reference(res, ref, name):
    for k in ("logz", "logzerr", "niter", "ncall", "nells", "samples",
              "samples_raw", "logwt"):
        np.testing.assert_array_equal(np.asarray(res[k]),
                                      ref[f"{name}/{k}"], err_msg=k)


def test_nested_analytic_evidence(ref):
    from scipy.stats import norm

    res = nested_sample(_gauss_loglike, _unit, D, nlive=300, dlogz=0.05,
                        seed=3)
    logz_true = D * np.log(norm.cdf((1 - MU) / S) - norm.cdf(-MU / S))
    assert res["logzerr"] < 0.2
    assert res["logz"] == pytest.approx(
        logz_true, abs=3.0 * res["logzerr"] + 0.05
    )
    # posterior moments of the (nearly untruncated) Gaussian
    assert np.allclose(res["samples"].mean(axis=0), MU, atol=0.02)
    assert np.allclose(res["samples"].std(axis=0), S, atol=0.03)
    _same_as_reference(res, ref, "analytic")


def test_nested_golden1_posterior_vs_gls(ref):
    """golden1's nested posterior around the port's GLS fit: every mean
    within 4 sigma of it and every std within 50% of the GLS
    uncertainty, logz finite, more than 200 iterations."""
    model, bundle, _ = state_from_numpy(load_state(ref, "golden1"),
                                        device="cpu")
    f = GLSFitter(bundle, model, fused=False, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f.fit_toas(maxiter=3)

    # x-space (internal units) sigmas of the fitted model
    def x_sigma(n):
        p = f.model.params[n]
        if type(p).__name__ == "AngleParameter":
            return float(p.internal_uncertainty())
        return float(p.uncertainty)

    sig = np.array([x_sigma(n) for n in f.cm.free_names])
    bt = BayesianTiming(
        f.model, bundle,
        priors={n: UniformBoundedRV(-8 * sig[i], 8 * sig[i])
                for i, n in enumerate(f.cm.free_names)},
        device="cpu",
    )
    res = bt.sample_nested(nlive=150, dlogz=0.2, seed=5)
    assert np.isfinite(res["logz"]) and res["niter"] > 200
    mean = res["samples"].mean(axis=0)
    std = res["samples"].std(axis=0)
    for i, n in enumerate(bt.param_names):
        assert abs(mean[i]) < 4.0 * sig[i], n
        assert std[i] == pytest.approx(sig[i], rel=0.5), n
    # one program: the live set cut into proposal-length batches
    assert len(bt.cm.programs) == 1


def test_nested_bimodal_multi_recovers_evidence(ref):
    res = nested_sample(_bimodal_loglike(), _unit, 2, nlive=200, seed=1,
                        method="multi")
    assert res["nells"] >= 2
    assert res["logz"] == pytest.approx(
        0.0, abs=3.0 * res["logzerr"] + 0.05
    )
    frac = float((res["samples"][:, 0] < 0.5).mean())
    assert 0.2 < frac < 0.8  # both modes carry weight
    lo = res["samples"][res["samples"][:, 0] < 0.5]
    assert np.allclose(lo.mean(axis=0), 0.15, atol=0.01)
    _same_as_reference(res, ref, "bimodal")


def test_nested_bimodal_single_provably_fails(ref):
    """Under method='single' the lone bounding ellipsoid spans the void
    between the modes: more than 10x the likelihood calls of 'multi', or
    the plateau guard raises."""
    ll = _bimodal_loglike()
    res_m = nested_sample(ll, _unit, 2, nlive=200, seed=1, method="multi")
    try:
        res_s = nested_sample(ll, _unit, 2, nlive=200, seed=1,
                              method="single")
        assert res_s["ncall"] > 10 * res_m["ncall"]
    except RuntimeError:
        pass  # the plateau guard fired: equally loud


def test_nested_unimodal_multi_matches_single(ref):
    res_m = nested_sample(_gauss_loglike, _unit, D, nlive=200, seed=5,
                          method="multi")
    res_s = nested_sample(_gauss_loglike, _unit, D, nlive=200, seed=5,
                          method="single")
    assert res_m["nells"] == 1
    assert res_m["logz"] == pytest.approx(
        res_s["logz"],
        abs=3.0 * (res_m["logzerr"] + res_s["logzerr"]),
    )
    _same_as_reference(res_m, ref, "unimodal_multi")
    _same_as_reference(res_s, ref, "unimodal_single")


def test_nested_segmented_and_checkpointed_is_the_same_run():
    """nested_init / nested_iterate in segments, through a checkpoint
    round trip between them, is draw for draw nested_sample's run."""
    whole = nested_sample(_gauss_loglike, _unit, D, nlive=100, seed=8)
    st = nested_init(_gauss_loglike, _unit, D, nlive=100, seed=8)
    nested_iterate(st, _gauss_loglike, _unit, 150)
    st = nested_restore_state(nested_checkpoint_state(st))
    while not nested_iterate(st, _gauss_loglike, _unit, 150):
        pass
    res = nested_result(st)
    np.testing.assert_array_equal(res["samples"], whole["samples"])
    assert res["logz"] == whole["logz"] and res["ncall"] == whole["ncall"]
