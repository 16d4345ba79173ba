"""Parity of the port's ensemble sampler and MCMCFitter
(``pint_tpu_torch/sampler.py``) with the JAX package.

- The port's stretch step, fed the reference's own draws (those of
  ``ensemble_keys``' keys, split and drawn as the reference's step draws
  them) from the reference's initial ensemble, gives the reference's
  chain and log-posteriors for 24 steps within 1e-12 relative, on a
  correlated-noise pulsar of the reference's simulation.
- The generator schedule: a run cut into segments is bitwise equal to the
  run without cuts; a segment past the plan raises.
- Twins of ``tests/test_mcmc_diagnostics.py``'s four tests and of
  ``tests/test_derived_l6.py::test_mcmc_correlated_noise_matches_gls_
  golden1`` (its white-noise sibling is in ``test_torch_bayesian.py``), at
  the reference's statistical gates, with the port's own draws and fits.

The reference runs once for the module in a subprocess
(tests/torch_reference.py).
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

from pint_tpu_torch.bayesian import BayesianTiming  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import GLSFitter  # noqa: E402
from pint_tpu_torch.sampler import (  # noqa: E402
    MCMCFitter,
    effective_sample_size,
    ensemble_keys,
    gelman_rubin,
    integrated_autocorr_time,
    run_ensemble,
)

LNL_PAR = (
    "PSR LNL\nF0 101.3 1\nF1 -2e-15 1\nPEPOCH 55000\nDM 7.7 1\n"
    "EFAC -f L-wide 1.2\nTNREDAMP -13.2\nTNREDGAM 3.1\nTNREDC 6\n"
)
NSTEPS, NWALKERS = 24, 16

_SCRIPT = textwrap.dedent(f"""
import warnings
import jax
from pint_tpu.models.builder import get_model_and_toas
from pint_tpu.sampler import (MCMCFitter, ensemble_init, ensemble_keys,
                              run_ensemble)
from pint_tpu.simulation import make_test_pulsar

# the stretch chain on a correlated-noise pulsar, and its draws
m, toas = make_test_pulsar({LNL_PAR!r}, ntoa=90, start_mjd=54200,
                           end_mjd=56200, seed=42)
mf = MCMCFitter(toas, m)
export_state(mf.bt.cm, "lnl")
cov = mf._init_cov()
x0 = np.zeros(mf.bt.nparams)
walkers, key = ensemble_init(x0, nwalkers={NWALKERS}, seed=7, init_cov=cov)
half = {NWALKERS} // 2
draws = []
for k in ensemble_keys(key, {NSTEPS}):
    ks = jax.random.split(k, 6)
    for h in (0, 3):
        draws.append(np.asarray(jax.random.uniform(ks[h], (half,))))
        draws.append(np.asarray(jax.random.randint(ks[h + 1], (half,), 0,
                                                   half)))
        draws.append(np.asarray(jax.random.uniform(ks[h + 2], (half,))))
chain, lnp, acc = run_ensemble(mf.bt.lnposterior, x0, nwalkers={NWALKERS},
                               nsteps={NSTEPS}, seed=7, init_cov=cov)
OUT["stretch/walkers0"] = np.asarray(walkers)
OUT["stretch/u"] = np.stack(draws[0::3])
OUT["stretch/j"] = np.stack(draws[1::3])
OUT["stretch/acc_u"] = np.stack(draws[2::3])
OUT["stretch/chain"] = chain
OUT["stretch/lnp"] = lnp
OUT["stretch/acceptance"] = np.array(acc)

# golden1 and its GLS fit
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    gm, gt = get_model_and_toas("tests/datafile/golden1.par",
                                "tests/datafile/golden1.tim")
export_state(gm.compile(gt), "golden1")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "sampler.npz")


def _state(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model, bundle


def _ref_draws(ref):
    u, j, a = ref["stretch/u"], ref["stretch/j"], ref["stretch/acc_u"]
    return [(u[2 * s], j[2 * s], a[2 * s], u[2 * s + 1], j[2 * s + 1],
             a[2 * s + 1]) for s in range(NSTEPS)]


def test_stretch_step_fed_reference_draws_matches_reference(ref):
    """24 stretch steps from the reference's initial ensemble and its
    draws: walkers and log-posteriors within 1e-12 relative of the
    reference's chain, and the same acceptance."""
    model, bundle = _state(ref, "lnl")
    bt = BayesianTiming(model, bundle, device="cpu")
    chain, lnp, acc = run_ensemble(
        bt.lnposterior, np.zeros(bt.nparams), nwalkers=NWALKERS,
        nsteps=NSTEPS, init_walkers=ref["stretch/walkers0"],
        draws=_ref_draws(ref), device="cpu")
    np.testing.assert_allclose(chain, ref["stretch/chain"], rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(lnp, ref["stretch/lnp"], rtol=1e-12, atol=0)
    assert acc == float(ref["stretch/acceptance"])
    assert 0.0 < acc < 1.0


def test_segmented_run_is_bitwise_the_uninterrupted_run(ref):
    """A run planned as 30 steps and executed as 12 + 18 (start,
    init_walkers, init_lp) is bitwise equal to the uninterrupted run;
    the schedule's step seeds depend on (seed, nsteps_total, i) only."""
    model, bundle = _state(ref, "lnl")
    bt = BayesianTiming(model, bundle, device="cpu")
    kw = dict(nwalkers=NWALKERS, seed=3, device="cpu",
              init_walkers=ref["stretch/walkers0"])
    x0 = np.zeros(bt.nparams)
    full, lnp_full, _ = run_ensemble(bt.lnposterior, x0, nsteps=30, **kw)
    a, lnp_a, _ = run_ensemble(bt.lnposterior, x0, nsteps=12,
                               nsteps_total=30, **kw)
    kw["init_walkers"] = a[-1]
    b, lnp_b, _ = run_ensemble(bt.lnposterior, x0, nsteps=18, start=12,
                               nsteps_total=30, init_lp=lnp_a[-1], **kw)
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    np.testing.assert_array_equal(np.concatenate([lnp_a, lnp_b]), lnp_full)
    assert ensemble_keys(3, 5, nsteps_total=30, start=12) == ensemble_keys(
        3, 30)[12:17]
    assert ensemble_keys(3, 5) != ensemble_keys(3, 30)[:5]
    with pytest.raises(ValueError, match="exceeds the planned"):
        ensemble_keys(3, 5, nsteps_total=3)


def test_iat_white_noise_is_unity():
    rng = np.random.default_rng(0)
    chain = rng.normal(size=(2000, 16, 3))
    tau = integrated_autocorr_time(chain)
    assert np.all(tau < 1.6)
    ess = effective_sample_size(chain)
    assert np.all(ess > 2000 * 16 / 1.6)
    assert np.all(gelman_rubin(chain) < 1.02)


def test_iat_ar1_matches_analytic():
    """AR(1) with coefficient a has tau = (1+a)/(1-a) exactly."""
    rng = np.random.default_rng(1)
    a = 0.9
    n, w = 20000, 8
    eps = rng.normal(size=(n, w))
    x = np.empty((n, w))
    x[0] = eps[0]
    for t in range(1, n):
        x[t] = a * x[t - 1] + eps[t]
    tau = integrated_autocorr_time(x[:, :, None])[0]
    tau_true = (1 + a) / (1 - a)  # 19.0
    assert tau == pytest.approx(tau_true, rel=0.25)


def test_rhat_flags_unmixed_walkers():
    rng = np.random.default_rng(2)
    chain = rng.normal(size=(1000, 8, 1)) * 0.1
    chain[:, 4:, 0] += 3.0  # half the ensemble stuck in another mode
    assert gelman_rubin(chain)[0] > 1.5


def test_mcmc_fitter_warns_on_short_chain():
    from pint_tpu_torch.simulation import make_test_pulsar

    par = "PSR M1\nF0 99.7 1\nF1 -2e-15 1\nPEPOCH 55000\nDM 7.5 1\n"
    m, toas = make_test_pulsar(par, ntoa=40, seed=4, device="cpu")
    f = MCMCFitter(toas, m, device="cpu")
    f.fit_toas(nsteps=60, nwalkers=16, seed=1)
    diag = f.convergence_diagnostics()
    assert set(diag) == {"tau", "ess", "rhat", "acceptance", "n_post"}
    assert np.all(np.isfinite(diag["tau"]))
    with pytest.warns(UserWarning, match="autocorrelation|R-hat"):
        f.get_posterior_samples()


def test_mcmc_correlated_noise_matches_gls_golden1(ref):
    """golden1 (ELL1, power-law red noise): the MCMC values within 5
    sigma of the GLS fit and the marginalized posterior widths within
    60% of the GLS uncertainties, the reference test's gates."""
    g_model, bundle = _state(ref, "golden1")
    g = GLSFitter(bundle, g_model, fused=False, device="cpu")
    g.fit_toas(maxiter=3)
    m, _ = _state(ref, "golden1")
    mf = MCMCFitter(bundle, m, device="cpu")
    mf.fit_toas(nsteps=500, nwalkers=32, seed=3)
    assert 0.05 < mf.acceptance < 0.95
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        samples = mf.get_posterior_samples()
    for name in ("F0", "F1", "DM"):
        i = mf.bt.param_names.index(name)
        p = g.model.params[name]
        sigma = float(p.uncertainty)
        v_gls = p.value
        v_gls = float(v_gls.to_float() if hasattr(v_gls, "to_float")
                      else v_gls)
        v_ref = mf.model.params[name]
        v_mcmc = v_ref.value
        v_mcmc = float(v_mcmc.to_float() if hasattr(v_mcmc, "to_float")
                       else v_mcmc)
        assert abs(v_mcmc - v_gls) < 5 * sigma, name
        assert np.std(samples[:, i]) / v_ref.scale_to_internal == (
            pytest.approx(sigma, rel=0.6)), name


@pytest.mark.gpu
def test_stretch_step_card_matches_cpu():
    """One stretch step on the card against the same step on the CPU,
    from the same walkers and the same draws, on a 2048-TOA pulsar
    simulated by the port (bench.py's composition): walkers within 1e-12
    and log-posteriors within 1e-10 relative, the same acceptances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from torch_reference import BENCH_PAR

    from pint_tpu_torch.sampler import make_stretch_step
    from pint_tpu_torch.simulation import make_test_pulsar

    model, toas = make_test_pulsar(BENCH_PAR, ntoa=2048, start_mjd=53000.0,
                                   end_mjd=57500.0, iterations=1,
                                   orbit=True, orbit_in_phase=True,
                                   device="cpu")
    rng = np.random.default_rng(21)
    sig = np.array([5e-10, 2e-9, 1e-5, 5e-12, 2e-19])
    walkers = rng.standard_normal((NWALKERS, 5)) * sig
    half = NWALKERS // 2
    draws = [rng.uniform(size=half), rng.integers(0, half, half),
             rng.uniform(size=half), rng.uniform(size=half),
             rng.integers(0, half, half), rng.uniform(size=half)]
    out = {}
    for dev in ("cuda", "cpu"):
        bt = BayesianTiming(model, toas, device=dev)
        lnpost_v = torch.func.vmap(bt.lnposterior)
        step = make_stretch_step(lnpost_v, bt.nparams, NWALKERS)
        w = torch.as_tensor(walkers, device=dev)
        args = [torch.as_tensor(v, device=dev) for v in draws]
        out[dev] = [t.cpu().numpy() for t in step(w, lnpost_v(w), *args)]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-12)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-10)
    assert int(out["cuda"][2]) == int(out["cpu"][2])
