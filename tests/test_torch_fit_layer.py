"""Parity of the port's fit layer with the JAX package.

The WLS step and fitter (``fitting/wls.py``), the downhill fitters
(``fitting/downhill.py``: the lambda ladder, the measured noise floor,
the fused loop and the host loop, the fault ladder), ``auto_fitter`` and
``ftest``, against the reference's on the same inputs.  The reference
runs once per module in a subprocess (tests/torch_reference.py); the
goldens' states are carried across with ``convert.state_from_numpy``,
and the step inputs as numpy arrays made here from seeds.  Tolerances
are stated per test.
"""

import ast
import inspect
import math
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
from pint_tpu_torch.exceptions import (  # noqa: E402
    ConvergenceWarning,
    CorrelatedErrors,
    GuardTripWarning,
    InvalidModelParameters,
    PintTpuError,
)
from pint_tpu_torch.fitting import (  # noqa: E402
    DownhillGLSFitter,
    DownhillWLSFitter,
    GLSFitter,
    MinimizeFitter,
    PowellFitter,
    WidebandDownhillFitter,
    WidebandTOAFitter,
    WLSFitter,
    auto_fitter,
    ftest,
)
from pint_tpu_torch.fitting.base import (  # noqa: E402
    design_with_offset,
    device_noise_floor,
)
from pint_tpu_torch.fitting.downhill import (  # noqa: E402
    DownhillFitter,
    _ladder_lams,
)
from pint_tpu_torch.fitting.wls import _wls_step  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
)

DATADIR = Path(__file__).parent / "datafile"
METHODS = ("svd", "qr", "gram")
MIN_LAMBDAS = (1e-3, 5e-4, 1e-4, 0.5)
#: (fitter, golden): the white goldens by WLS and downhill WLS, the
#: correlated ones (red noise; ECORR) by downhill GLS
FIT_CASES = [("WLSFitter", "golden2"), ("WLSFitter", "golden14"),
             ("DownhillWLSFitter", "golden2"),
             ("DownhillWLSFitter", "golden14"),
             ("DownhillGLSFitter", "golden1"),
             ("DownhillGLSFitter", "golden3")]
STEMS = sorted({s for _, s in FIT_CASES})
FTEST_CASES = [(100.0, 98, 99.0, 96), (1000.0, 98, 96.0, 96),
               (100.0, 96, 99.0, 98), (512.3, 400, 480.1, 397)]
#: a white spindown pulsar for the port-only behaviours
PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
"""
RED = "TNREDAMP -13.0\nTNREDGAM 3.0\nTNREDC 10\n"
#: the dense-step cases: _white()'s TOAs under PAR ("white") and under
#: PAR + RED ("red")
DENSE_CASES = ("white", "red")


def kahan(p):
    """A Kahan-type matrix: ones on the diagonal and -1 above it.  Its
    diagonal is benign, but one singular value is ~2^-p of the largest
    (the rest stay above ~0.04 at p = 48): what unpivoted QR's diagonal
    does not reveal and its one-solve condition estimate does."""
    return np.eye(p) - np.triu(np.ones((p, p)), 1)


def wls_inputs():
    """case -> (r, M, w): a seeded well-conditioned design whose columns
    span ten decades, and a Kahan-type near-degenerate one."""
    rng = np.random.default_rng(11)
    n, p = 600, 12
    seeded = (rng.standard_normal(n),
              rng.standard_normal((n, p)) * np.logspace(0, 10, p),
              rng.uniform(0.5, 2.0, n))
    q, _ = np.linalg.qr(rng.standard_normal((144, 48)))
    near = (rng.standard_normal(144), q @ kahan(48),
            rng.uniform(0.5, 2.0, 144))
    return {"seeded": seeded, "kahan": near}


def floor_inputs():
    """case -> (lams, c): the probe lambdas of the default ladder plus the
    baseline, with chi2 trials on a line through 0 plus seeded scatter;
    the same at a realistic chi2 level (1234.5); with one NaN trial; and
    with only three finite trials."""
    _, _, all_lams = _ladder_lams(1e-3)
    lams = all_lams[-5:]
    rng = np.random.default_rng(5)
    c = -40.0 * lams + rng.normal(0.0, 1e-6, lams.size)
    nan1 = c.copy()
    nan1[1] = np.nan
    few = c.copy()
    few[:2] = [np.nan, np.inf]
    return {"scatter": (lams, c), "level": (lams, c + 1234.5),
            "one_nan": (lams, nan1), "three_finite": (lams, few)}


_SCRIPT = textwrap.dedent(f"""
import contextlib
import warnings
import jax.numpy as jnp
from ingest_env import INGEST_STEMS, golden_ingest_env
import pint_tpu.fitting.wls as rwls
from pint_tpu.fitting import (DownhillGLSFitter, DownhillWLSFitter,
                              WLSFitter, ftest)
from pint_tpu.fitting.base import device_noise_floor
from pint_tpu.fitting.downhill import DownhillFitter, _ladder_lams
from pint_tpu.models.builder import get_model_and_toas
from pint_tpu.models.timing_model import reference_values
from pint_tpu.timebase.hostdd import HostDD

inp = np.load(os.environ["FIT_LAYER_INPUTS"])
for case in ("seeded", "kahan"):
    r, M, w = (jnp.asarray(inp[f"wls/{{case}}/{{k}}"]) for k in "rMw")
    for method in {METHODS!r}:
        dx, cov, nbad = rwls._wls_step(r, M, w, method=method)
        OUT[f"wls/{{case}}/{{method}}/dx"] = np.asarray(dx)
        OUT[f"wls/{{case}}/{{method}}/cov"] = np.asarray(cov)
        OUT[f"wls/{{case}}/{{method}}/nbad"] = np.asarray(nbad)
for ml in {MIN_LAMBDAS!r}:
    OUT[f"lams/{{ml!r}}"] = _ladder_lams(ml)[2]
for case in ("scatter", "level", "one_nan", "three_finite"):
    lams, c = inp[f"floor/{{case}}/lams"], inp[f"floor/{{case}}/c"]
    OUT[f"floor/{{case}}/device"] = np.asarray(
        device_noise_floor(jnp.asarray(lams), jnp.asarray(c)))
    OUT[f"floor/{{case}}/host"] = np.asarray(
        DownhillFitter._chi2_noise_floor(lams, c))
for i, args in enumerate({FTEST_CASES!r}):
    OUT[f"ftest/{{i}}"] = np.asarray(ftest(*args))
from pint_tpu.fitting.gls import gls_step_full_cov
for case in {DENSE_CASES!r}:
    args = [jnp.asarray(inp[f"dense/{{case}}/{{i}}"]) for i in range(5)]
    dx, (covn, _), chi2, _ = gls_step_full_cov(*args, method="f64",
                                               normalized_cov=True)
    OUT[f"dense/{{case}}/dx"] = np.asarray(dx)
    OUT[f"dense/{{case}}/covn"] = np.asarray(covn)
    OUT[f"dense/{{case}}/chi2"] = np.asarray(chi2)


def load(stem):
    env = (golden_ingest_env() if stem in INGEST_STEMS
           else contextlib.nullcontext())
    with warnings.catch_warnings(), env:
        warnings.simplefilter("ignore")
        return get_model_and_toas(f"tests/datafile/{{stem}}.par",
                                  f"tests/datafile/{{stem}}.tim")


def internal(model, names):
    ref = reference_values(model)
    out = []
    for n in names:
        v = ref[n]
        out.append([v.hi, v.lo] if isinstance(v, HostDD) else [v, 0.0])
    return np.array(out, float)


for stem in {STEMS!r}:
    model, toas = load(stem)
    export_state(model.compile(toas), stem)
classes = dict(WLSFitter=WLSFitter, DownhillWLSFitter=DownhillWLSFitter,
               DownhillGLSFitter=DownhillGLSFitter)
for cls, stem in {FIT_CASES!r}:
    model, toas = load(stem)
    f = classes[cls](toas, model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas()
    key = f"fit/{{cls}}/{{stem}}"
    OUT[key + "/chi2"] = np.asarray(chi2)
    OUT[key + "/converged"] = np.asarray(f.converged)
    OUT[key + "/niter"] = np.asarray(getattr(f, "niter", -1))
    OUT[key + "/internal"] = internal(model, f.cm.free_names)
    OUT[key + "/cov"] = np.asarray(f.parameter_covariance_matrix)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    arrays = {}
    for case, (r, M, w) in wls_inputs().items():
        arrays.update({f"wls/{case}/r": r, f"wls/{case}/M": M,
                       f"wls/{case}/w": w})
    for case, (lams, c) in floor_inputs().items():
        arrays.update({f"floor/{case}/lams": lams, f"floor/{case}/c": c})
    for case in DENSE_CASES:
        for i, a in enumerate(_dense_inputs(case)):
            arrays[f"dense/{case}/{i}"] = a.numpy()
    np.savez(d / "inputs.npz", **arrays)
    return run_reference(_SCRIPT, d / "fit_layer.npz",
                         env={"FIT_LAYER_INPUTS": str(d / "inputs.npz")},
                         timeout=900)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _state(ref, stem):
    return state_from_numpy(load_state(ref, stem), device="cpu")[:2]


def _internal(model, names):
    """(len(names), 2) internal values as (hi, lo) pairs."""
    out = []
    for n in names:
        v = model.params[n].internal()
        out.append([v.hi, v.lo] if hasattr(v, "hi") else [float(v), 0.0])
    return np.array(out, float)


# -- the WLS step ---------------------------------------------------------
@pytest.mark.parametrize("case,method", [("seeded", m) for m in METHODS]
                         + [("kahan", "qr"), ("kahan", "gram")])
def test_wls_step_matches_reference(ref, case, method):
    """dx, covariance and the degenerate count of each method against the
    reference's on the same (r, M, w): rel 1e-10 for svd and qr, 1e-8 for
    gram (eigh of the Gram, which squares the condition), nbad equal.  On
    the Kahan-type design the qr gate must send the solve to gram: its
    answer is the gram answer and is held at gram's tolerance."""
    r, M, w = (_t(a) for a in wls_inputs()[case])
    dx, cov, nbad = _wls_step(r, M, w, method=method)
    key = f"wls/{case}/{method}"
    tol = 1e-10 if method != "gram" and case == "seeded" else 1e-8
    assert _rel(dx, ref[key + "/dx"]) <= tol
    assert _rel(cov, ref[key + "/cov"]) <= tol
    assert int(nbad) == int(ref[key + "/nbad"])
    if case == "kahan":
        gdx, gcov, gbad = _wls_step(r, M, w, method="gram")
        assert int(nbad) >= 1
        assert torch.equal(dx, gdx) and torch.equal(cov, gcov)


def test_wls_step_qr_routes_underdetermined_to_gram():
    """n < p: R is not square, so 'qr' takes the gram answer."""
    rng = np.random.default_rng(2)
    r, M, w = (_t(rng.standard_normal(6)), _t(rng.standard_normal((6, 9))),
               _t(rng.uniform(0.5, 2.0, 6)))
    got = _wls_step(r, M, w, method="qr")
    want = _wls_step(r, M, w, method="gram")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2]) >= 3


# -- the fitters' signatures (ROADMAP C R5) ---------------------------------
REF_FITTING = Path(__file__).resolve().parent.parent / "pint_tpu" / "fitting"
PORT_FITTERS = [GLSFitter, WLSFitter, DownhillWLSFitter, DownhillGLSFitter,
                WidebandTOAFitter, WidebandDownhillFitter, MinimizeFitter,
                PowellFitter]


def _reference_positional(name):
    """The positional parameter names of the reference's class ``name``,
    read from its source by ``ast`` (no JAX import): its own ``__init__``
    or the first one up its bases."""
    classes = {}
    for path in sorted(REF_FITTING.glob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ClassDef):
                init = next((f for f in node.body
                             if isinstance(f, ast.FunctionDef)
                             and f.name == "__init__"), None)
                classes[node.name] = (
                    [getattr(b, "id", getattr(b, "attr", None))
                     for b in node.bases], init)

    def find(n):
        if n not in classes:
            return None
        bases, init = classes[n]
        if init is not None:
            return [a.arg for a in init.args.args]
        return next((got for got in map(find, bases) if got), None)

    return find(name)


@pytest.mark.parametrize("cls", PORT_FITTERS, ids=lambda c: c.__name__)
def test_fitter_positional_parameters_are_the_references(cls):
    """Each fitter takes the reference's positional parameters, in its
    order; ``device`` is keyword-only."""
    sig = inspect.signature(cls.__init__).parameters
    positional = [n for n, p in sig.items()
                  if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert positional == _reference_positional(cls.__name__)
    assert sig["device"].kind is inspect.Parameter.KEYWORD_ONLY


def test_glsfitter_full_cov_is_refused_as_the_reference_does(ref):
    """``GLSFitter(t, m, True, True)``: the reference's PintTpuError (the
    fused and mixed paths are reduced-rank), the one full_cov refusal
    left; ``full_cov=True`` alone builds a fitter whose first step is the
    reference's dense step on the same inputs (dx within 1e-10 of its
    largest component, chi2 and the normalized covariance 1e-10
    relative)."""
    model, toas = _white()
    for fused in (True, "mixed"):
        with pytest.raises(PintTpuError, match="mutually exclusive"):
            GLSFitter(toas, model, True, fused, device="cpu")
    f = GLSFitter(toas, model, True, device="cpu")
    assert f.full_cov and f._step_mode() == "full_cov"
    _assert_dense_step(ref, f._gn_step(f.cm.x0(), "full_cov"), "white")
    f = GLSFitter(toas, model, False, False, device="cpu")
    assert f.fused is False


# -- the downhill ladder and its noise floor --------------------------------
@pytest.mark.parametrize("min_lambda", MIN_LAMBDAS)
def test_ladder_lams_match_reference(ref, min_lambda):
    """The trials, the probes and the baseline, value for value."""
    lams, probes, all_lams = _ladder_lams(min_lambda)
    assert np.array_equal(all_lams, ref[f"lams/{min_lambda!r}"])
    assert all_lams[-1] == 0.0 and len(probes) == 4
    assert all(p < min_lambda for p in probes)


@pytest.mark.parametrize("case", ["scatter", "level", "one_nan",
                                  "three_finite"])
def test_device_noise_floor_matches_reference(ref, case):
    """The port's device floor against the reference's device floor and
    against both packages' host floors (np.polyfit), within 1e-12
    relative; NaN and Inf trials are masked out, and fewer than 4 finite
    trials give 0.  At a chi2 level of 1234.5 the floor's mean subtraction
    cancels nine digits, so there the floors agree within 1e-12 of the
    level (the sums' order sets the last digits)."""
    lams, c = floor_inputs()[case]
    got = float(device_noise_floor(_t(lams), _t(c)))
    host = DownhillFitter._chi2_noise_floor(lams, c)
    tol = 1e-12 * (np.nanmax(np.abs(c)) if case == "level" else abs(got))
    for want in (float(ref[f"floor/{case}/device"]),
                 float(ref[f"floor/{case}/host"]), host):
        assert abs(got - want) <= tol
    if case == "three_finite":
        assert got == 0.0
    else:
        assert got > 0.0


# -- the fitters on the goldens ----------------------------------------------
@pytest.mark.parametrize("cls,stem", FIT_CASES)
def test_golden_fits(ref, cls, stem):
    """Each fitter on the golden's state at tests/test_golden_regression.py's
    criteria against the oracle (chi2 1e-6 relative, values within 1e-3
    sigma, uncertainties 1e-6 relative), and against the reference's fit
    of the same state by the same fitter: the same converged flag and (for
    the downhill fitters) the same number of iterations, values within
    1e-8 relative."""
    model, bundle = _state(ref, stem)
    f = {"WLSFitter": WLSFitter, "DownhillWLSFitter": DownhillWLSFitter,
         "DownhillGLSFitter": DownhillGLSFitter}[cls](bundle, model,
                                                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas()
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    assert chi2 == pytest.approx(float(oracle["chi2"]), rel=1e-6)
    for name, val, unc in zip(oracle["names"], oracle["values"],
                              oracle["uncs"]):
        p = model.params[str(name)]
        assert abs(float(p.value) - val) < 1e-3 * unc, name
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), name
    key = f"fit/{cls}/{stem}"
    assert f.converged == bool(ref[key + "/converged"])
    if cls != "WLSFitter":
        assert f.niter == int(ref[key + "/niter"])
    got = _internal(model, f.cm.free_names)
    want = ref[key + "/internal"]
    diff = np.abs((got[:, 0] - want[:, 0]) + (got[:, 1] - want[:, 1]))
    sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
    # rel 1e-8 reads nothing of a value within a few sigma of zero (JUMP,
    # PX, DM1), where the packages' residuals, 1e-11 s apart, already
    # move it ~1e-7 sigma: those are held within 1e-6 sigma instead
    ok = diff <= np.maximum(1e-8 * np.abs(want[:, 0]), 1e-6 * sig)
    assert np.all(ok), dict(zip(f.cm.free_names, diff / sig))


# -- the downhill loops and the fault ladder ---------------------------------
def _white(n=200, seed=1, f0_offset=0.0, par=PAR):
    """A white spindown pulsar simulated from PAR, fitted from ``par`` with
    F0 moved by ``f0_offset`` Hz (5e-10 is ~0.1 cycle over the span)."""
    _, toas = make_test_pulsar(PAR, ntoa=n, seed=seed, device="cpu",
                               freqs=(1400.0, 2300.0))
    model = get_model(par)
    if f0_offset:
        f0 = model.params["F0"]
        f0.set_internal(f0.internal() + f0_offset)
    return model, toas


def _dense_inputs(case):
    """(r, M, Ndiag, T, phi) of the first step of a fitter of
    ``_white()``'s TOAs under PAR or PAR + RED, from the par values."""
    model, toas = _white(par=PAR if case == "white" else PAR + RED)
    cm = model.compile(toas, device="cpu")
    x0 = cm.x0()
    return (cm.time_residuals(x0, subtract_mean=False),
            design_with_offset(cm, x0), torch.square(cm.scaled_sigma(x0)),
            *cm.noise_basis_or_empty(x0))


def _assert_dense_step(ref, step, case):
    """A fitter's first step ``(x0 + dx, (covn, norm), chi2, nbad)`` from
    x0 = 0 against the reference's f64 dense step of ``case``: dx within
    1e-10 of its largest component, the normalized covariance 1e-10,
    chi2 (where given) 1e-10 relative."""
    xn, (covn, _), chi2, _ = step
    key = f"dense/{case}"
    assert _rel(xn, ref[key + "/dx"][1:]) <= 1e-10
    assert _rel(covn, ref[key + "/covn"]) <= 1e-10
    if chi2 is not None:
        assert float(chi2) == pytest.approx(float(ref[key + "/chi2"]),
                                            rel=1e-10)


def _values(f):
    return _internal(f.model, f.cm.free_names)


@pytest.mark.parametrize("case", ["golden2", "golden3", "offset_start"])
def test_fused_loop_matches_host_loop(ref, monkeypatch, case):
    """The fused loop (decisions on the device) against the host loop
    (PINT_TPU_TORCH_DOWNHILL_FUSED=0) on the same state: the same
    converged flag and number of iterations, chi2 and values within 1e-8
    relative, uncertainties within 1e-8 relative."""
    out = {}
    for mode in ("fused", "host"):
        if mode == "host":
            monkeypatch.setenv("PINT_TPU_TORCH_DOWNHILL_FUSED", "0")
        else:
            monkeypatch.delenv("PINT_TPU_TORCH_DOWNHILL_FUSED", raising=False)
        if case == "offset_start":
            model, toas = _white(f0_offset=5e-10)
            f = DownhillWLSFitter(toas, model, device="cpu")
        else:
            model, bundle = _state(ref, case)
            cls = DownhillWLSFitter if case == "golden2" else DownhillGLSFitter
            f = cls(bundle, model, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            chi2 = f.fit_toas()
        unc = np.sqrt(np.diag(f.parameter_covariance_matrix))
        out[mode] = (f.converged, f.niter, chi2, _values(f), unc)
    (cf, nf, xf, vf, uf), (ch, nh, xh, vh, uh) = out["fused"], out["host"]
    assert cf == ch is True
    assert nf == nh >= 1
    assert xf == pytest.approx(xh, rel=1e-8)
    np.testing.assert_allclose(vf[:, 0] + vf[:, 1], vh[:, 0] + vh[:, 1],
                               rtol=1e-8, atol=0)
    np.testing.assert_allclose(uf, uh, rtol=1e-8, atol=0)


def test_downhill_converges_from_offset_start():
    """F0 moved by ~0.1 cycle over the span: the downhill fit walks back
    to the simulated F0 (within 5e-12 Hz) and converges, its noise floor
    at rounding level on the CPU."""
    model, toas = _white(f0_offset=5e-10)
    f = DownhillWLSFitter(toas, model, device="cpu")
    chi2 = f.fit_toas()
    assert f.converged and f.guard_report.rung == "native"
    assert float(model.params["F0"].value) == pytest.approx(
        245.4261196898081, abs=5e-12)
    assert 0.0 <= f.last_noise_floor < 1e-6 * max(chi2, 1.0)


def test_step_problem_warns_and_leaves_converged_false():
    """A negated Gauss-Newton direction with the honest predicted decrease:
    no lambda realizes it, so the fit warns (ConvergenceWarning naming the
    prediction), keeps the best-known parameters and is not converged."""
    model, toas = _white(f0_offset=5e-10)
    f = DownhillWLSFitter(toas, model, device="cpu")
    real_make = f._make_proposal

    def negated(force_f64=False):
        real = real_make(force_f64)

        def proposal(x):
            dx, cov, nbad, pred = real(x)
            return -dx, cov, nbad, pred

        return proposal

    f._make_proposal = negated
    with pytest.warns(ConvergenceWarning, match="predicted"):
        f.fit_toas()
    assert not f.converged


def test_downhill_wls_refuses_correlated_model():
    """Correlated noise: DownhillWLSFitter refuses at construction and
    WLSFitter at fit_toas, with the reference's CorrelatedErrors."""
    model, toas = _white(par=PAR + RED)
    with pytest.raises(CorrelatedErrors, match="PLRedNoise"):
        DownhillWLSFitter(toas, model, device="cpu")
    f = WLSFitter(toas, model, device="cpu")
    with pytest.raises(CorrelatedErrors):
        f.fit_toas()


@pytest.mark.parametrize("par,downhill,cls", [
    (PAR, True, DownhillWLSFitter), (PAR, False, WLSFitter),
    (PAR + RED, True, DownhillGLSFitter), (PAR + RED, False, GLSFitter)])
def test_auto_fitter_selection(par, downhill, cls):
    """Correlated noise -> GLS, else WLS; downhill by default; the
    fitter runs on the device given."""
    model, toas = _white(par=par)
    f = auto_fitter(toas, model, downhill=downhill, device="cpu")
    assert type(f) is cls and f.device == torch.device("cpu")


def test_auto_fitter_refuses_wideband_and_full_cov(ref):
    """Wideband TOAs (every TOA flagged with pp_dm) go to the wideband
    fitters, which refuse them without pp_dme errors.  full_cov is no
    longer refused: the dense-covariance downhill fitter's first proposal
    is the reference's dense step on the same inputs (1e-10), and
    auto_fitter passes full_cov through as the reference's does."""
    model, toas = _white()
    wide = dict(toas, flags=[dict(f, pp_dm="3.1") for f in toas["flags"]])
    with pytest.raises(PintTpuError, match="pp_dme"):
        auto_fitter(wide, model, device="cpu")
    f = DownhillGLSFitter(toas, get_model(PAR + RED), device="cpu",
                          full_cov=True)
    x0 = f.cm.x0()
    dx, cov, nbad, _ = f._make_proposal()(x0)
    _assert_dense_step(ref, (x0 + dx, cov, None, nbad), "red")
    g = auto_fitter(toas, get_model(PAR + RED), full_cov=True, device="cpu")
    assert type(g) is DownhillGLSFitter and g.full_cov


def test_nan_proposal_is_served_by_the_f64_rung():
    """A native proposal poisoned with NaN freezes the fused loop; the
    ladder refuses it and the all-f64 proposal serves the fit."""
    model, toas = _white(par=PAR + RED)
    f = DownhillGLSFitter(toas, model, device="cpu")
    real_make = f._make_proposal

    def poisoned(force_f64=False):
        real = real_make(force_f64)
        if force_f64:
            return real

        def proposal(x):
            dx, cov, nbad, pred = real(x)
            return dx * float("nan"), cov, nbad, pred

        return proposal

    f._make_proposal = poisoned
    with pytest.warns(GuardTripWarning, match="'native'"):
        chi2 = f.fit_toas()
    rep = f.guard_report
    assert rep.rung == "f64-fallback" and rep.rung_index == 1
    assert rep.history[0][0] == "native"
    assert "froze on a non-finite proposal" in rep.history[0][1]
    assert math.isfinite(chi2) and f.converged


def test_host_loop_is_the_last_rung(monkeypatch):
    """Both fused rungs refused: the host loop serves, on the same device."""
    from pint_tpu_torch.exceptions import PintTpuNumericsError

    model, toas = _white()
    f = DownhillWLSFitter(toas, model, device="cpu")

    def refused(*a, **k):
        raise PintTpuNumericsError("injected")

    monkeypatch.setattr(f, "_fused_loop", refused)
    with pytest.warns(GuardTripWarning):
        chi2 = f.fit_toas()
    assert f.guard_report.rung == "host-loop"
    assert [h[0] for h in f.guard_report.history] == ["native",
                                                      "f64-fallback"]
    assert math.isfinite(chi2) and f.converged


@pytest.mark.parametrize("fused", ["1", "0"])
def test_non_finite_start_raises(monkeypatch, fused):
    """A model whose start chi2 is not finite is the caller's error:
    InvalidModelParameters, on either loop, with no rung tried again."""
    monkeypatch.setenv("PINT_TPU_TORCH_DOWNHILL_FUSED", fused)
    model, toas = _white()
    f = DownhillWLSFitter(toas, model, device="cpu")
    monkeypatch.setattr(f.cm, "chi2", lambda x: torch.sum(x) * float("nan"))
    with pytest.raises(InvalidModelParameters):
        f.fit_toas()


def test_warm_start():
    """A warm start of the wrong shape raises ValueError; the converged
    solution as a warm start converges at its first iteration."""
    model, toas = _white(f0_offset=5e-10)
    f = DownhillWLSFitter(toas, model, device="cpu")
    with pytest.raises(ValueError, match="warm-start"):
        f.fit_toas(x0=np.zeros(len(f.cm.free_names) + 1))
    f.fit_toas()
    f.fit_toas(x0=np.zeros(len(f.cm.free_names)))
    assert f.converged and f.niter == 1


def test_wls_fit_runs_one_rung():
    """WLS is its own f64 path: one rung, named after the device and the
    solve method (the CPU's svd)."""
    model, toas = _white()
    f = WLSFitter(toas, model, device="cpu")
    f.fit_toas()
    assert f.guard_report.rung == "cpu-svd" and not f.guard_report.fell_back
    assert f.wls_method == "svd"


@pytest.mark.parametrize("i", range(len(FTEST_CASES)))
def test_ftest_matches_reference(ref, i):
    """The same p-value (NaN for an invalid nesting)."""
    got, want = ftest(*FTEST_CASES[i]), float(ref[f"ftest/{i}"])
    assert (math.isnan(got) and math.isnan(want)) or got == want


def test_mixed_downhill_proposal_on_the_msp(monkeypatch):
    """The downhill GLS proposal in its card mode (mixed), forced on the
    CPU, on the 2048-TOA binary MSP copy with 12 DMX ranges: its joint
    Gram goes through _joint_gram's fused dispatcher (the CUDA kernel's
    plain version here), and the proposal lands within the mixed step's
    gates of the f64 proposal: dx 2e-3 of the largest component, the
    predicted decrease 1e-3 relative, the normalized covariance 5e-3."""
    from pint_tpu_torch.fitting import downhill
    from pint_tpu_torch.ops import fused_gram

    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    monkeypatch.setattr(downhill, "default_accel_mode", lambda cm: "mixed")
    calls = []
    real = fused_gram.fused_gram_joint

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(fused_gram, "fused_gram_joint", counted)
    model, toas = make_test_pulsar(msp_par(12, seed=0), ntoa=2048,
                                   device="cpu", start_mjd=53000.0,
                                   end_mjd=57500.0, seed=0, iterations=1,
                                   orbit=True, freqs=MSP_FREQS)
    f = DownhillGLSFitter(toas, model, device="cpu")
    x = f.cm.x0()
    dx_m, (cov_m, _), _, pred_m = f._make_proposal()(x)
    assert calls == [(2048, 60)]
    dx_f, (cov_f, _), _, pred_f = f._make_proposal(force_f64=True)(x)
    assert len(calls) == 1
    assert float(torch.max(torch.abs(dx_m - dx_f))
                 / torch.max(torch.abs(dx_f))) <= 2e-3
    assert abs(float(pred_m - pred_f)) <= 1e-3 * abs(float(pred_f))
    assert float(torch.max(torch.abs(cov_m - cov_f))
                 / torch.max(torch.abs(cov_f))) <= 5e-3


# -- on the card -----------------------------------------------------------
@pytest.mark.gpu
def test_downhill_gls_on_card_goes_through_the_kernel(monkeypatch):
    """On the card auto_fitter's DownhillGLSFitter takes the mixed proposal,
    whose joint Gram is fused_gram_joint (at least one launch an
    iteration), on the native rung; its host loop takes the same
    iterations to the same chi2 (1e-8 relative)."""
    from torch_reference import BENCH_PAR

    from pint_tpu_torch.ops import fused_gram

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=4096, seed=0, orbit=True,
                                   device=dev)
    f = auto_fitter(toas, model)
    before = fused_gram.fused_gram_joint_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        chi2 = f.fit_toas()
        assert type(f) is DownhillGLSFitter and math.isfinite(chi2)
        assert f.guard_report.rung == "native"
        assert fused_gram.fused_gram_joint_cuda.launches - before >= f.niter
        monkeypatch.setenv("PINT_TPU_TORCH_DOWNHILL_FUSED", "0")
        h = auto_fitter(toas, get_model(BENCH_PAR))
        chi2_h = h.fit_toas()
    assert h.niter == f.niter
    assert chi2_h == pytest.approx(chi2, rel=1e-8)
