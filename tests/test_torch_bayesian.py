"""Parity of the port's Bayesian timing (``pint_tpu_torch/bayesian.py``,
``models/priors.py``) with the JAX package.

Twins of ``tests/test_derived_l6.py``'s ``test_correlated_lnlike_matches_
dense``, ``test_free_noise_hyperparameter_sampled`` and
``test_prior_transform_and_bounds``, on the reference's own pulsars (its
simulation and ingest, carried across by ``export_state``), each also held
to the reference's values at the same x; and the port's own checks: the
vmapped log-posterior of 16 walkers equals a loop over them, the step
program of one x equals the function, a proposal outside the physical
range gives a non-finite likelihood instead of raising.  And the twin of
``test_bayesian_lnpost_and_mcmc_matches_wls``: an MCMCFitter on the white
pulsar against the port's WLS fit.  The reference runs once for the
module in a subprocess (tests/torch_reference.py).
"""

import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.bayesian import BayesianTiming, lnlikelihood_cm  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import WLSFitter  # noqa: E402
from pint_tpu_torch.models.priors import (  # noqa: E402
    NormalRV,
    UniformBoundedRV,
    UniformUnboundedRV,
    default_prior,
)
from pint_tpu_torch.sampler import MCMCFitter  # noqa: E402

LNL_PAR = (
    "PSR LNL\nF0 101.3 1\nF1 -2e-15 1\nPEPOCH 55000\nDM 7.7 1\n"
    "EFAC -f L-wide 1.2\nTNREDAMP -13.2\nTNREDGAM 3.1\nTNREDC 6\n"
)
HYP_PAR = (
    "PSR HYP\nF0 88.8 1\nPEPOCH 55000\nDM 3.3\n"
    "EFAC -f L-wide 1.1\nTNREDAMP -13.2 1\nTNREDGAM 3.5\nTNREDC 5\n"
)

_SCRIPT = textwrap.dedent(f"""
import jax.numpy as jnp
from pint_tpu.bayesian import BayesianTiming
from pint_tpu.models.builder import get_model
from pint_tpu.models.priors import NormalRV, UniformBoundedRV
from pint_tpu.simulation import make_test_pulsar
from test_derived_l6 import PAR, _toas

def mk(par, n):
    return make_test_pulsar(par, ntoa=n, start_mjd=54200, end_mjd=56200,
                            seed=42)

# the correlated lnlikelihood at the reference test's three draws
m, toas = mk({LNL_PAR!r}, 90)
bt = BayesianTiming(m, toas)
export_state(bt.cm, "lnl")
rng = np.random.default_rng(0)
xs = np.stack([rng.normal(0.0, 1.0, bt.nparams)
               * np.array([1e-10, 1e-18, 1e-5][: bt.nparams])
               for _ in range(3)])
OUT["lnl/x"] = xs
OUT["lnl/ln"] = np.array([float(bt.lnlikelihood(jnp.asarray(x)))
                          for x in xs])
OUT["lnl/names"] = np.array(bt.param_names)

# a free TNREDAMP
m, toas = mk({HYP_PAR!r}, 70)
bt = BayesianTiming(m, toas)
export_state(bt.cm, "hyp")
i = bt.param_names.index("TNREDAMP")
x = np.zeros(bt.nparams)
l0 = float(bt.lnlikelihood(jnp.asarray(x)))
x[i] = 0.8
OUT["hyp/l"] = np.array([l0, float(bt.lnlikelihood(jnp.asarray(x)))])

# bounded and normal priors on the reference test's pulsar
m = get_model(PAR)
toas = _toas(m, n=40)
pri = {{"F0": UniformBoundedRV(-1e-9, 1e-9), "F1": NormalRV(0.0, 1e-18),
        "DM": UniformBoundedRV(-1e-3, 1e-3)}}
bt = BayesianTiming(m, toas, priors=pri)
export_state(bt.cm, "pri")
rng = np.random.default_rng(4)
X = np.stack([rng.normal(0.0, 1.0, 3) * np.array([3e-10, 1e-18, 3e-4])
              for _ in range(8)])
OUT["pri/x"] = X
OUT["pri/lnpost"] = np.array([float(bt.lnposterior(jnp.asarray(x)))
                              for x in X])
OUT["pri/lnprior"] = np.array([float(bt.lnprior(jnp.asarray(x)))
                               for x in X])
OUT["pri/cube"] = np.array([bt.prior_transform(c) for c in
                            np.random.default_rng(5).uniform(size=(4, 3))])

# the white-noise pulsar of test_bayesian_lnpost_and_mcmc_matches_wls
export_state(get_model(PAR).compile(_toas(get_model(PAR), n=80)), "white")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "bayes.npz")


def _bt(ref, name, priors=None):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return BayesianTiming(model, bundle, priors=priors, device="cpu")


def test_correlated_lnlike_matches_dense(ref):
    """The Woodbury-marginalized log-likelihood equals the dense
    multivariate-normal evaluation of the port's own residuals and
    covariance, and the reference's log-likelihood, at rel=1e-10,
    abs=1e-6 (the reference test's gate)."""
    bt = _bt(ref, "lnl")
    assert bt.param_names == list(ref["lnl/names"])
    for x, ln_ref in zip(ref["lnl/x"], ref["lnl/ln"]):
        xt = torch.as_tensor(x)
        ln_w = float(bt.lnlikelihood(xt))
        r = bt.cm.time_residuals(xt).numpy()
        C = bt.cm.noise_covariance(xt).numpy()
        _, logdet = np.linalg.slogdet(C)
        ln_dense = float(-0.5 * (r @ np.linalg.solve(C, r) + logdet
                                 + len(r) * np.log(2 * np.pi)))
        assert ln_w == pytest.approx(ln_dense, rel=1e-10, abs=1e-6)
        assert ln_w == pytest.approx(float(ln_ref), rel=1e-10, abs=1e-6)


def test_free_noise_hyperparameter_sampled(ref):
    """A free TNREDAMP enters x and moves the marginalized likelihood,
    as in the reference (its two values within rel=1e-10, abs=1e-6)."""
    bt = _bt(ref, "hyp")
    assert "TNREDAMP" in bt.param_names
    i = bt.param_names.index("TNREDAMP")
    x = np.zeros(bt.nparams)
    l0 = float(bt.lnlikelihood(x))
    x[i] = 0.8  # TNREDAMP -13.2 -> -12.4
    l1 = float(bt.lnlikelihood(x))
    assert np.isfinite(l0) and np.isfinite(l1) and l0 != l1
    np.testing.assert_allclose([l0, l1], ref["hyp/l"], rtol=1e-10,
                               atol=1e-6)


def test_prior_transform_and_bounds(ref):
    """The reference test's bounds and prior transform; the port's
    lnprior, lnposterior and prior transform equal the reference's at
    the same points (rel=1e-10, abs=1e-6; -inf outside a bound)."""
    pri = {"F0": UniformBoundedRV(-1e-9, 1e-9), "F1": NormalRV(0.0, 1e-18),
           "DM": UniformBoundedRV(-1e-3, 1e-3)}
    bt = _bt(ref, "pri", priors=pri)
    i_f0 = bt.param_names.index("F0")
    i_dm = bt.param_names.index("DM")
    cube = np.full(3, 0.5)
    cube[i_dm] = 0.25
    x = bt.prior_transform(cube)
    assert x[i_f0] == pytest.approx(0.0, abs=1e-12)
    assert x[i_dm] == pytest.approx(-5e-4, rel=1e-9)
    assert np.isfinite(float(bt.lnposterior(np.zeros(3))))
    bad = np.zeros(3)
    bad[i_f0] = 2e-9  # outside the F0 bounds
    assert float(bt.lnprior(bad)) == -np.inf
    got_prior = [float(bt.lnprior(x)) for x in ref["pri/x"]]
    got_post = [float(bt.lnposterior(x)) for x in ref["pri/x"]]
    want_prior = ref["pri/lnprior"]
    finite = np.isfinite(want_prior)
    np.testing.assert_array_equal(np.isfinite(got_prior), finite)
    np.testing.assert_allclose(np.asarray(got_prior)[finite],
                               want_prior[finite], rtol=1e-10, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_post)[finite],
                               ref["pri/lnpost"][finite], rtol=1e-10,
                               atol=1e-6)
    cubes = np.random.default_rng(5).uniform(size=(4, 3))
    np.testing.assert_allclose([bt.prior_transform(c) for c in cubes],
                               ref["pri/cube"], rtol=1e-14, atol=0)


def test_lnposterior_vmap_matches_loop(ref):
    """The vmapped log-posterior of 16 walkers equals a loop of single
    evaluations (rtol 1e-12), on the correlated-noise pulsar, through
    the step program of a batch and directly."""
    bt = _bt(ref, "lnl")
    rng = np.random.default_rng(9)
    X = torch.as_tensor(rng.standard_normal((16, bt.nparams))
                        * np.array([1e-10, 1e-18, 1e-5]))
    batched = torch.func.vmap(bt.lnposterior)(X).numpy()
    prog = bt.lnposterior_batch(16)(X).numpy()
    loop = np.array([float(bt.lnposterior(x)) for x in X])
    np.testing.assert_allclose(batched, loop, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(prog, batched)
    one = bt.lnposterior_jit()
    assert float(one(X[3])) == float(bt.lnposterior(X[3]))


def test_bayesian_lnpost_and_mcmc_matches_wls(ref):
    """The reference test's pulsar and gates: acceptance in (0.05, 0.95),
    the posterior std of F0 within 50% of the WLS uncertainty, the
    committed F0 within 4 sigma of the WLS value."""
    m_wls, bundle, _ = state_from_numpy(load_state(ref, "white"),
                                        device="cpu")
    WLSFitter(bundle, m_wls, device="cpu").fit_toas()
    sigma_f0 = m_wls.params["F0"].uncertainty

    m, _, _ = state_from_numpy(load_state(ref, "white"), device="cpu")
    mf = MCMCFitter(bundle, m, device="cpu")
    mf.fit_toas(nsteps=400, nwalkers=32, seed=2)
    assert 0.05 < mf.acceptance < 0.95
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        samples = mf.get_posterior_samples()
    i_f0 = mf.bt.param_names.index("F0")
    assert np.std(samples[:, i_f0]) == pytest.approx(sigma_f0, rel=0.5)
    v_mcmc = float(m.params["F0"].value.to_float())
    v_wls = float(m_wls.params["F0"].value.to_float())
    assert abs(v_mcmc - v_wls) < 4 * sigma_f0


def test_default_prior_and_internal_uncertainty():
    """default_prior reads ``internal_uncertainty``: a normal prior of 10x
    the par-file uncertainty in internal units (F1 scale 1, an H:M:S
    angle in seconds of time, an epoch in days), else improper."""
    from pint_tpu_torch.models.builder import get_model

    m = get_model("PSR P\nF0 100.0 1 1e-11\nF1 -1e-15 1\nPEPOCH 55000\n"
                  "RAJ 17:44:29.4 1 0.002\nDECJ -11:34:54.6 1 0.03\n"
                  "DM 3.1 1 0.001\n")
    assert isinstance(default_prior(m.params["F1"]), UniformUnboundedRV)
    p = default_prior(m.params["F0"])
    assert isinstance(p, NormalRV) and p.sigma == pytest.approx(1e-10)
    ra = m.params["RAJ"].internal_uncertainty()
    assert ra == pytest.approx(0.002 * np.pi / (12 * 3600), rel=1e-15)
    dec = m.params["DECJ"].internal_uncertainty()
    assert dec == pytest.approx(0.03 * np.pi / (180 * 3600), rel=1e-15)
    pe = m.params["PEPOCH"]
    pe.uncertainty = 1e-3
    assert pe.internal_uncertainty() == pytest.approx(86.4)


def test_nonphysical_proposal_is_not_finite_and_does_not_raise(ref):
    """A noise proposal outside the physical range (a TNREDAMP so large
    that phi overflows) gives a likelihood that is not finite, through
    the NaN-poisoning Cholesky, with no exception: the samplers reject
    it."""
    bt = _bt(ref, "hyp")
    i = bt.param_names.index("TNREDAMP")
    x = torch.zeros(bt.nparams, dtype=torch.float64)
    x[i] = 400.0
    val = float(lnlikelihood_cm(bt.cm, x))
    assert not np.isfinite(val)
    X = torch.zeros((4, bt.nparams), dtype=torch.float64)
    X[1, i] = 400.0
    vals = torch.func.vmap(bt.lnlikelihood)(X).numpy()
    assert np.isfinite(vals[0]) and not np.isfinite(vals[1])


@pytest.mark.gpu
def test_batched_lnposterior_card_matches_cpu():
    """The log-posterior of 64 walkers as one step program on the card
    (bench.py's composition at 2048 TOAs, simulated by the port, red
    noise marginalized) against the CPU: rel=1e-10, abs=1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from torch_reference import BENCH_PAR

    from pint_tpu_torch.simulation import make_test_pulsar

    model, toas = make_test_pulsar(BENCH_PAR, ntoa=2048, start_mjd=53000.0,
                                   end_mjd=57500.0, iterations=1,
                                   orbit=True, orbit_in_phase=True,
                                   device="cpu")
    rng = np.random.default_rng(12)
    X = rng.standard_normal((64, 5)) * np.array(
        [5e-10, 2e-9, 1e-5, 5e-12, 2e-19])
    out = {}
    for dev in ("cuda", "cpu"):
        bt = BayesianTiming(model, toas, device=dev)
        prog = bt.lnposterior_batch(64)
        out[dev] = prog(torch.as_tensor(X, device=dev)).cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-10,
                               atol=1e-6)
