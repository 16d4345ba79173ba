"""The reference's NANOGrav configurations, BASELINE configs 2 and 3, as
copies of 2048 TOAs (32 observing epochs of 64) on the CPU.

- Config 2, ``simulation.j1713_par``: a J1713+0747-like pulsar with a DD
  orbit, FD1-FD3, a JUMP, EFAC/EQUAD/ECORR on two receivers and
  30-harmonic red noise, fitted by the default entry point
  (``auto_fitter``: downhill GLS).
- Config 3, ``simulation.b1855_par``: the binary MSP with ECORR on both
  receivers, fitted by ``GLSFitter`` with the Woodbury step and with the
  dense covariance (``full_cov=True``).

The port simulates each copy (``epoch_mjds``: TOAs 1 s apart alternating
between the receivers' sub-bands, each receiver's TOAs of a session one
ECORR epoch; the synthetic orbit inside the phases) and hands the table
to the reference, which builds its model with ``ModelBuilder`` and
exports its state; the port builds the same composition with its own
``ModelBuilder`` and fits the reference's state.  Each copy has 24 DMX
ranges in place of the configuration's 100, so that every range holds
an epoch (the card's phase 21 runs the full widths).

Gates: one f64 step and each fit against the reference's, at the step
gates (dx and fitted values 2e-3 of sigma, chi2 1e-3 relative,
covariance 5e-3 of its largest element); config 3's Woodbury fit against
its dense fit at ``tests/test_noise_gls.py:114-121``'s bar (chi2 1e-8
relative, F0 and F1 1e-10 relative, uncertainties 1e-6 relative) and
every fitted value within 1e-6 of its sigma.

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

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import GLSFitter, auto_fitter  # noqa: E402
from pint_tpu_torch.fitting.downhill import DownhillGLSFitter  # noqa: E402
from pint_tpu_torch.fitting.gls import gls_step_woodbury  # noqa: E402
from pint_tpu_torch.fitting.spread import step_inputs  # noqa: E402
from pint_tpu_torch.models.builder import ModelBuilder  # noqa: E402
from pint_tpu_torch.models.timing_model import reference_values  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    J1713_SPAN,
    MSP_SPAN,
    NANOGRAV_FREQS,
    b1855_par,
    epoch_mjds,
    j1713_par,
    make_test_pulsar,
    orbit_pos_m,
)
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402

NDMX = 24
NEPOCH, PER_EPOCH = 32, 64
CONFIGS = {"j1713": (j1713_par(NDMX), J1713_SPAN),
           "b1855": (b1855_par(NDMX), MSP_SPAN)}
MAXITER = {"j1713": 6, "b1855": 3}
#: the values tests/test_noise_gls.py:114-121 holds at 1e-10 relative (its
#: DM is frozen here); every value is also held within 1e-6 of its sigma
BAR_VALUES = ("F0", "F1")


def simulate(name):
    """(model, table) of a config's 2048-TOA copy, by the port on the
    CPU."""
    par, span = CONFIGS[name]
    return make_test_pulsar(
        par, mjds=epoch_mjds(NEPOCH, PER_EPOCH, *span), start_mjd=span[0],
        seed=3, iterations=1, orbit=True, orbit_in_phase=True,
        freqs=NANOGRAV_FREQS, device="cpu")


_SCRIPT = textwrap.dedent(f"""
import jax.numpy as jnp
import pint_tpu.fitting.gls as rgls
CONFIGS = {dict((k, v[0]) for k, v in CONFIGS.items())!r}
MAXITER = {MAXITER!r}
from pint_tpu.fitting import GLSFitter, auto_fitter
from pint_tpu.fitting.base import design_with_offset
from pint_tpu.models.builder import ModelBuilder
from pint_tpu.models.timing_model import reference_values
from pint_tpu.timebase.hostdd import HostDD
from pint_tpu.timebase.times import TimeArray
from pint_tpu.toas.ingest import ingest_barycentric
from pint_tpu.toas.toas import TOAs


def toas_of(name):
    z = np.load(os.environ["TABLES"] + f"/{{name}}.npz")
    t = TOAs(TimeArray(z["day"].astype(np.int64), HostDD(z["hi"], z["lo"]),
                       "tdb"), z["freq"], z["err"], ["@"] * len(z["freq"]),
             [{{"f": str(f)}} for f in z["flags"]])
    ingest_barycentric(t)
    t.ssb_obs_pos = z["pos_m"]
    return t


def values(model, prefix):
    for n, v in reference_values(model).items():
        if isinstance(v, HostDD):
            OUT[f"{{prefix}}/{{n}}"] = np.array([v.hi, v.lo], float)
        elif isinstance(v, tuple) and isinstance(v[1], HostDD):
            OUT[f"{{prefix}}/{{n}}"] = np.array([v[0], v[1].hi, v[1].lo],
                                                float)
        elif not isinstance(v, (bool, str, tuple)):
            OUT[f"{{prefix}}/{{n}}"] = np.array([v], float)


for name, par in CONFIGS.items():
    toas = toas_of(name)
    model = ModelBuilder()(par)
    cm = model.compile(toas)
    export_state(cm, name)
    META[name + "/components"] = list(model.components)
    x0 = cm.x0()
    r = cm.time_residuals(x0, subtract_mean=False)
    T, phi = cm.noise_basis_or_empty(x0)
    OUT[f"{{name}}/k"] = np.array(T.shape[1])
    dx, (covn, norm), chi2, _ = rgls.gls_step_woodbury(
        r, design_with_offset(cm, x0), jnp.square(cm.scaled_sigma(x0)),
        T, phi, normalized_cov=True)
    OUT[f"{{name}}/step/dx"] = np.asarray(dx)
    OUT[f"{{name}}/step/covn"] = np.asarray(covn)
    OUT[f"{{name}}/step/norm"] = np.asarray(norm)
    OUT[f"{{name}}/step/chi2"] = np.asarray(chi2)
    os.environ["PINT_TPU_SOLVE_IR"] = "force"  # the accelerator's policy
    dx, (covn, norm), chi2, _ = rgls.gls_step_woodbury_mixed(
        r, design_with_offset(cm, x0), jnp.square(cm.scaled_sigma(x0)),
        T, phi, normalized_cov=True)
    del os.environ["PINT_TPU_SOLVE_IR"]
    OUT[f"{{name}}/mixed/dx"] = np.asarray(dx)
    OUT[f"{{name}}/mixed/covn"] = np.asarray(covn)
    OUT[f"{{name}}/mixed/chi2"] = np.asarray(chi2)
    fitter = (auto_fitter(toas, model) if name == "j1713"
              else GLSFitter(toas, model))
    chi2 = fitter.fit_toas(maxiter=MAXITER[name])
    OUT[f"{{name}}/fit/chi2"] = np.array(chi2)
    OUT[f"{{name}}/fit/cov"] = np.asarray(fitter.parameter_covariance_matrix)
    META[name + "/fitter"] = type(fitter).__name__
    META[name + "/free"] = list(fitter.cm.free_names)
    values(model, f"{{name}}/fit/value")
""")


@pytest.fixture(scope="module")
def sims():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {name: simulate(name) for name in CONFIGS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, sims):
    d = tmp_path_factory.mktemp("nanograv")
    for name, (_, t) in sims.items():
        sec = HostDD(t["tdb_sec_hi"], t["tdb_sec_lo"])
        pos_m = orbit_pos_m(t["tdb_day"], sec, CONFIGS[name][1][0])
        np.savez(d / f"{name}.npz", day=t["tdb_day"], hi=t["tdb_sec_hi"],
                 lo=t["tdb_sec_lo"], freq=t["freq_mhz"], err=t["error_us"],
                 flags=np.array([f["f"] for f in t["flags"]]), pos_m=pos_m)
    return run_reference(_SCRIPT, d / "nanograv.npz", timeout=900,
                         env={"TABLES": str(d)})


def _state(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model, bundle


def _par_float(v) -> float:
    """A par-file value as one float (an epoch as its MJD)."""
    if isinstance(v, HostDD):
        return float(v.hi) + float(v.lo)
    if isinstance(v, tuple):
        return float(v[0]) + (float(v[1].hi) + float(v[1].lo)) / 86400.0
    return float(v)


def _fitted_gaps(model, ref, name, free):
    """max over the free parameters of |port - reference| fitted value
    in units of the port's uncertainty (both in internal units, as
    differences of the same exact anchors)."""
    mine = reference_values(model)
    worst = 0.0
    for n in free:
        # the difference of two double-doubles, pairwise: no cancellation
        want = ref[f"{name}/fit/value/{n}"]
        v = mine[n]
        if isinstance(v, HostDD):
            d = (float(v.hi) - want[0]) + (float(v.lo) - want[1])
        elif isinstance(v, tuple):
            d = ((float(v[0]) - want[0]) * 86400.0
                 + (float(v[1].hi) - want[1]) + (float(v[1].lo) - want[2]))
        else:
            d = float(v) - float(want[0])
        sig = model.params[n].internal_uncertainty()
        worst = max(worst, abs(d) / sig)
    return worst


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_builder_and_widths(ref, sims, name):
    """Both packages' ModelBuilder build the same composition, and the
    copy has the configuration's noise width: two ECORR columns an epoch
    and 60 red-noise columns."""
    par, _ = CONFIGS[name]
    port = ModelBuilder()(par)
    assert list(port.components) == ref["__meta__"][name + "/components"]
    model, bundle = _state(ref, name)
    cm = model.compile(bundle)
    T, _ = cm.noise_basis_or_empty(cm.x0())
    assert T.shape[1] == int(ref[f"{name}/k"]) == 2 * NEPOCH + 60
    # the port's own simulation builds the same masks from its own table
    own = sims[name][0].compile(sims[name][1], device="cpu")
    T_own, _ = own.noise_basis_or_empty(own.x0())
    assert torch.equal(T, T_own)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_f64_step_matches_reference(ref, name):
    model, bundle = _state(ref, name)
    cm = model.compile(bundle)
    dx, (covn, norm), chi2, _ = gls_step_woodbury(
        *step_inputs(cm, cm.x0()), normalized_cov=True)
    want_dx = ref[f"{name}/step/dx"]
    want_cov = ref[f"{name}/step/covn"]
    sig = np.sqrt(np.diag(want_cov)) / ref[f"{name}/step/norm"]
    assert np.max(np.abs(dx.numpy() - want_dx) / sig) <= 2e-3
    assert abs(float(chi2) / float(ref[f"{name}/step/chi2"]) - 1) <= 1e-3
    assert (np.max(np.abs(covn.numpy() - want_cov))
            <= 5e-3 * np.max(np.abs(want_cov)))
    assert np.array_equal(norm.numpy(), ref[f"{name}/step/norm"]) or (
        np.max(np.abs(norm.numpy() / ref[f"{name}/step/norm"] - 1)) <= 1e-12)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mixed_step_matches_reference(ref, name, monkeypatch):
    """The mixed step on the CPU's Gram route (``gram32_joint``: f32
    values summed in f32 chunks, both packages) under the accelerator's
    solve policy (the f32 noise system refined in f64, its residual check
    armed) against the reference's under its own: dx, the covariance and
    chi2 each within a tenth of the reference's gap to the f64 step.  At
    config 3's full size that route's step is 2.8e-2 (dx) off the f64
    step in both packages, where the card's fused kernel, whose sums are
    f64, is 2.7e-6 off (PERF.md)."""
    from pint_tpu_torch.fitting.gls import gls_step_woodbury_mixed

    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    model, bundle = _state(ref, name)
    cm = model.compile(bundle)
    dx, (covn, _), chi2, _ = gls_step_woodbury_mixed(
        *step_inputs(cm, cm.x0()), normalized_cov=True)
    want_chi2 = float(ref[f"{name}/mixed/chi2"])
    f64_chi2 = float(ref[f"{name}/step/chi2"])
    assert np.isfinite(want_chi2) and np.isfinite(float(chi2))
    # the two mixed steps within a tenth of their gap to the f64 step
    assert abs(float(chi2) - want_chi2) <= 0.1 * abs(want_chi2 - f64_chi2)
    for got, key in ((dx.numpy(), "dx"), (covn.numpy(), "covn")):
        want, exact = ref[f"{name}/mixed/{key}"], ref[f"{name}/step/{key}"]
        assert (np.max(np.abs(got - want))
                <= 0.1 * np.max(np.abs(want - exact))), key


@pytest.fixture(scope="module")
def fits(ref):
    """name -> the port's fit of the reference's state: config 2 through
    ``auto_fitter``, config 3 by ``GLSFitter`` with the Woodbury step and
    with the dense covariance."""
    out = {}
    model, bundle = _state(ref, "j1713")
    f = auto_fitter(bundle, model, device="cpu")
    out["j1713"] = (f, f.fit_toas(maxiter=MAXITER["j1713"]))
    for key, full in (("b1855", False), ("b1855 dense", True)):
        model, bundle = _state(ref, "b1855")
        f = GLSFitter(bundle, model, full_cov=full, device="cpu")
        out[key] = (f, f.fit_toas(maxiter=MAXITER["b1855"]))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fit_matches_reference(ref, fits, name):
    f, chi2 = fits[name]
    meta = ref["__meta__"]
    assert type(f).__name__ == meta[name + "/fitter"]
    if name == "j1713":
        assert isinstance(f, DownhillGLSFitter)
    assert list(f.cm.free_names) == meta[name + "/free"]
    assert not f.guard_report.fell_back
    assert abs(chi2 / float(ref[f"{name}/fit/chi2"]) - 1) <= 1e-3
    assert _fitted_gaps(f.model, ref, name, meta[name + "/free"]) <= 2e-3
    cov, want = f.parameter_covariance_matrix, ref[f"{name}/fit/cov"]
    assert np.max(np.abs(cov - want)) <= 5e-3 * np.max(np.abs(want))


def test_woodbury_fit_matches_dense_fit(fits):
    """Config 3: the Woodbury fit against the dense-covariance fit, at
    tests/test_noise_gls.py:114-121's bar."""
    (fw, cw), (fd, cd) = fits["b1855"], fits["b1855 dense"]
    assert fd.full_cov and not fw.full_cov
    assert cw == pytest.approx(cd, rel=1e-8)
    assert list(fw.cm.free_names) == list(fd.cm.free_names)
    for n in fw.cm.free_names:
        v1, v2 = (_par_float(m.params[n].value) for m in (fw.model, fd.model))
        sig = fd.model.params[n].uncertainty
        if n in BAR_VALUES:
            assert v1 == pytest.approx(v2, rel=1e-10, abs=1e-30), n
        assert abs(v1 - v2) <= 1e-6 * sig, n
        assert fw.model.params[n].uncertainty == pytest.approx(
            sig, rel=1e-6), n
