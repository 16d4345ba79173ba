"""Parity of the port's streaming-basis GLS route with the JAX package.

The port's ``ops/fourier.py`` (``fourier_gram``, ``fourier_apply``), the
streaming-basis step ``gls_step_woodbury_fourier``, ``GLSFitter(
fused=True)`` and the fit's fallback ladder, against the reference's on
the same inputs.  The reference runs once per module in a subprocess
(tests/torch_reference.py); its Pallas kernels run in interpret mode on
the CPU, as its own tests run them.  On the CPU the port's dispatchers
take the kernels' plain versions; the ``gpu``-marked tests hold the CUDA
kernels to those plain versions on the card.
"""

import json
import math
import shutil
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    BENCH_PAR,
    bench_build_script,
    load_state,
    run_reference,
)

import pint_tpu_torch.ops.fourier as fourier  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.exceptions import (  # noqa: E402
    GuardTripWarning,
    LadderExhausted,
    PintTpuError,
)
from pint_tpu_torch.fitting import gls  # noqa: E402
from pint_tpu_torch.fitting.base import design_with_offset  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    gls_step_woodbury,
    gls_step_woodbury_fourier,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.runtime.fallback import fit_rungs  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

GRAM_SHAPES = [(500, 5, 3), (3000, 30, 8), (128, 1, 1)]

#: tests/test_pallas_kernels.py::test_gls_fitter_fused_matches_f64's par
FIT_PAR = (
    "PSR F\nF0 245.42 1\nF1 -5e-16 1\nPEPOCH 55000\nDM 3.14 1\n"
    "TNREDAMP -13.0\nTNREDGAM 3.5\nTNREDC 10\n"
)
#: tests/test_pallas_kernels.py::test_gls_mixed_step_matches_f64_ecorr's
ECORR_PAR = (
    "PSR E\nF0 245.42 1\nF1 -5e-16 1\nPEPOCH 55000\nDM 3.14 1\n"
    "EFAC -f L-wide 1.2\nECORR -f L-wide 0.8\n"
    "TNREDAMP -13.0\nTNREDGAM 3.5\nTNREDC 8\n"
)

_SCRIPT = textwrap.dedent(f"""
import warnings
import jax.numpy as jnp
import pint_tpu.fitting.gls as rgls
from pint_tpu.fitting import GLSFitter
from pint_tpu.fitting.base import design_with_offset
from pint_tpu.models.builder import get_model
from pint_tpu.ops.pallas_kernels import fourier_apply, fourier_gram
from pint_tpu.simulation import make_test_pulsar

# the kernels, in interpret mode, on tests/test_pallas_kernels.py's inputs
for n, k, p in {GRAM_SHAPES!r}:
    rng = np.random.default_rng(1)
    tspan = 3.0e8
    t = np.sort(rng.uniform(0, tspan, n))
    freqs = np.arange(1, k + 1) / tspan
    w = rng.uniform(0.5, 2.0, n)
    X = rng.normal(size=(n, p))
    sig, twx = fourier_gram(jnp.asarray(t), jnp.asarray(freqs),
                            jnp.asarray(w), jnp.asarray(X))
    for name, v in dict(t=t, freqs=freqs, w=w, X=X, sig=sig, twx=twx).items():
        OUT[f"gram/{{n}}/{{name}}"] = np.asarray(v)
rng = np.random.default_rng(2)
n, k, m = 1000, 12, 4
tspan = 1.0e8
t = np.sort(rng.uniform(0, tspan, n))
freqs = np.arange(1, k + 1) / tspan
z = rng.normal(size=(2 * k, m))
y = fourier_apply(jnp.asarray(t), jnp.asarray(freqs), jnp.asarray(z))
for name, v in dict(t=t, freqs=freqs, z=z, y=y).items():
    OUT[f"apply/{{name}}"] = np.asarray(v)

# the streaming-basis step and the f64 step on the bench state
x0 = cm.x0()
r = cm.time_residuals(x0, subtract_mean=False)
M = design_with_offset(cm, x0)
Nd = jnp.square(cm.scaled_sigma(x0))
dx, (covn, _), chi2, _ = rgls.gls_step_woodbury_fourier(
    r, M, Nd, *cm.noise_fourier_spec(x0), normalized_cov=True)
OUT["step/fourier/dx"] = np.asarray(dx)
OUT["step/fourier/covn"] = np.asarray(covn)
OUT["step/fourier/chi2"] = np.asarray(chi2)

# GLSFitter(fused=True) on the fused-fit test's pulsar
_, ftoas = make_test_pulsar({FIT_PAR!r}, ntoa=200, seed=6)
export_state(get_model({FIT_PAR!r}).compile(ftoas), "fit_state")
m32 = get_model({FIT_PAR!r})
f = GLSFitter(ftoas, m32, fused=True)
OUT["fit/chi2"] = np.asarray(f.fit_toas(maxiter=3))
OUT["fit/values"] = np.array([
    float(m32.params[n].value.to_float())
    if hasattr(m32.params[n].value, "to_float")
    else float(m32.params[n].value) for n in f.cm.free_names])
OUT["fit/uncs"] = np.array(
    [float(m32.params[n].uncertainty) for n in f.cm.free_names])
OUT["fit/report"] = np.array(json.dumps(f.guard_report.to_dict()))

# the ECORR + red-noise pulsar: its state and its two steps
_, etoas = make_test_pulsar({ECORR_PAR!r}, ntoa=240, seed=7)
ecm = get_model({ECORR_PAR!r}).compile(etoas)
export_state(ecm, "ecorr_state")
ex0 = ecm.x0()
eargs = (ecm.time_residuals(ex0, subtract_mean=False),
         design_with_offset(ecm, ex0), jnp.square(ecm.scaled_sigma(ex0)),
         *ecm.noise_basis_or_empty(ex0))
for name, step in (("f64", rgls.gls_step_woodbury),
                   ("mixed", rgls.gls_step_woodbury_mixed)):
    dx, (covn, _), chi2, _ = step(*eargs, normalized_cov=True)
    OUT[f"ecorr/{{name}}/dx"] = np.asarray(dx)
    OUT[f"ecorr/{{name}}/covn"] = np.asarray(covn)
    OUT[f"ecorr/{{name}}/chi2"] = np.asarray(chi2)

# the ladder on an injected failure: the native step's chi2 made NaN
real = rgls.gls_step_woodbury_fourier


def poisoned(*a, **k):
    dx, cov, chi2, nbad = real(*a, **k)
    return dx, cov, chi2 * jnp.nan, nbad


rgls.gls_step_woodbury_fourier = poisoned
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    fl = GLSFitter(ftoas, get_model({FIT_PAR!r}), fused=True)
    fl.fit_toas(maxiter=3)
rgls.gls_step_woodbury_fourier = real
OUT["ladder/report"] = np.array(json.dumps(fl.guard_report.to_dict()))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(
        bench_build_script(512) + _SCRIPT,
        tmp_path_factory.mktemp("ref") / "fourier.npz",
    )


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _f64_basis(t, freqs):
    arg = 2.0 * np.pi * t[:, None] * freqs[None, :]
    return np.concatenate([np.sin(arg), np.cos(arg)], axis=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _poison_chi2(fn):
    def poisoned(*a, **k):
        dx, cov, chi2, nbad = fn(*a, **k)
        return dx, cov, chi2 * float("nan"), nbad

    return poisoned


# -- the kernels' functions ------------------------------------------------
@pytest.mark.parametrize("n,k,p", GRAM_SHAPES)
def test_fourier_gram_matches_reference(ref, n, k, p):
    """Sigma and TWX within 1e-5 of each output's max of the reference's
    interpret-mode kernel (the same f32 basis values; f64 sums here, f32
    sums there), and both within the reference's own 2e-3 of the
    f64-basis Gram."""
    g = {name: ref[f"gram/{n}/{name}"] for name in
         ("t", "freqs", "w", "X", "sig", "twx")}
    sig, twx = fourier.fourier_gram(_t(g["t"]), _t(g["freqs"]), _t(g["w"]),
                                    _t(g["X"]))
    assert sig.dtype == torch.float64 and sig.shape == (2 * k, 2 * k)
    assert twx.shape == (2 * k, p)
    assert torch.equal(sig, sig.T)
    assert _rel(sig, g["sig"]) <= 1e-5
    assert _rel(twx, g["twx"]) <= 1e-5
    T = _f64_basis(g["t"], g["freqs"])
    sig64 = T.T @ (g["w"][:, None] * T)
    twx64 = T.T @ (g["w"][:, None] * g["X"])
    for got in (sig.numpy(), g["sig"]):
        assert _rel(got, sig64) <= 2e-3
    for got in (twx.numpy(), g["twx"]):
        assert _rel(got, twx64) <= 2e-3


def test_fourier_apply_matches_reference(ref):
    """y = T z within 1e-5 of max|y| of the reference's kernel, and within
    its own 2e-3 of the f64-basis product."""
    t, freqs, z = (ref[f"apply/{k}"] for k in ("t", "freqs", "z"))
    y = fourier.fourier_apply(_t(t), _t(freqs), _t(z))
    assert y.dtype == torch.float32 and y.shape == (1000, 4)
    assert _rel(y, ref["apply/y"]) <= 1e-5
    assert _rel(y, _f64_basis(t, freqs) @ z) <= 2e-3


def test_fourier_gram_weights_zero_padding():
    """Zero-weight TOAs add exact zeros (the padding convention of
    test_fourier_gram_weights_zero_padding): 1e-12 relative."""
    rng = np.random.default_rng(3)
    n, k = 700, 7
    t = np.sort(rng.uniform(0, 1e7, n))
    freqs = np.arange(1, k + 1) / 1e7
    w = rng.uniform(0.5, 2.0, n)
    w[500:] = 0.0
    X = rng.normal(size=(n, 2))
    full = fourier.fourier_gram(_t(t), _t(freqs), _t(w), _t(X))
    cut = fourier.fourier_gram(_t(t[:500]), _t(freqs), _t(w[:500]),
                               _t(X[:500]))
    for a, b in zip(full, cut):
        assert _rel(a, b) <= 1e-12


def test_fourier_shape_table_and_refusals():
    """The shape tables keep the bench shape's geometry and take every p
    and m (one launch per slice of gram_columns(k) or M_MAX columns) and
    k up to what the card's shared memory holds, with 6 tiles a warp
    where one block fills an SM (k = 64, p = 16: 2 tile groups); the CUDA
    wrappers refuse wider k, and the unported precision rungs, before any
    launch, while the dispatchers' CPU route takes every shape."""
    assert fourier.fourier_gram_table(100_000, 30, 7) == (
        264, 1, 64, 72, 24, 384)
    assert fourier.fourier_gram_table(1000, 5, 3)[0] == 16  # ceil(n / 64)
    assert fourier.fourier_gram_table(10, 64, 16)[1:5] == (2, 128, 144, 88)
    assert fourier.fourier_gram_table(10, 65, 7) is not None
    assert fourier.fourier_gram_table(10, 30, 17) is not None
    assert fourier.fourier_gram_table(10, 425, 7) is None
    assert fourier.fourier_apply_table(1000, 64, 16) == (8, 256)
    assert fourier.fourier_apply_table(100_000, 30, 8) == (782, 256)
    assert fourier.fourier_apply_table(1000, 12, 17) == (8, 256)
    assert fourier.fourier_apply_table(1000, 599, 3) is None
    t = torch.linspace(0.0, 1e8, 50, dtype=torch.float64)
    f = torch.arange(1, 426, dtype=torch.float64) / 1e8
    w = torch.ones(50, dtype=torch.float64)
    with pytest.raises(ValueError, match="outside fourier_gram_table"):
        fourier.fourier_gram_cuda(t, f, w, torch.ones((50, 3),
                                                      dtype=torch.float64))
    f599 = torch.arange(1, 600, dtype=torch.float64) / 1e8
    with pytest.raises(ValueError, match="outside fourier_apply_table"):
        fourier.fourier_apply_cuda(t, f599, torch.ones((1198, 3),
                                                       dtype=torch.float64))
    sig, twx = fourier.fourier_gram(t, f[:65], w,
                                    torch.ones((50, 17), dtype=torch.float64))
    assert sig.shape == (130, 130) and twx.shape == (130, 17)
    assert fourier.fourier_apply(t, f[:4], torch.ones(
        (8, 17), dtype=torch.float64)).shape == (50, 17)
    with pytest.raises(ValueError, match="unknown precision"):
        fourier.fourier_gram(t, f[:4], w, torch.ones((50, 3),
                                                     dtype=torch.float64),
                             precision="medium")
    with pytest.raises(ValueError, match="one card"):
        fourier.fourier_gram_cuda(t, f[:4], w,
                                  torch.ones((50, 3), dtype=torch.float64))


def _identity_blocks(k2):
    """The 2k x 2k identity cut into blocks of at most M_MAX columns:
    (first column, block)."""
    eye = torch.eye(k2, dtype=torch.float64)
    return [(c, eye[:, c:c + fourier.M_MAX].contiguous())
            for c in range(0, k2, fourier.M_MAX)]


@pytest.mark.parametrize("n,k", [(3000, 30), (999, 7), (64, 64)])
def test_fourier_apply_plain_identity_is_basis32(n, k):
    """The plain side of chip_smoke.py's basis check: fourier_apply_plain
    with z a block of identity columns is the matching columns of
    basis32, bit for bit (each output is one product by 1.0 plus exact
    zeros)."""
    rng = np.random.default_rng(4)
    tspan = 3.89e8
    t = _t(np.sort(rng.uniform(0, tspan, n)))
    f = _t(np.arange(1, k + 1) / tspan)
    T = fourier.basis32(t, f)
    for c, Z in _identity_blocks(2 * k):
        assert torch.equal(fourier.fourier_apply(t, f, Z),
                           T[:, c:c + Z.shape[1]])


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) names a new build of every
    kernel, so a stale library is never loaded; needs no nvcc."""
    from pint_tpu_torch.ops import _cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC", csrc)
    monkeypatch.setattr(_cuda_build, "BUILD", tmp_path / "_build")
    before = {n: _cuda_build.library_path(n)
              for n in ("fourier_gram", "fourier_apply", "fused_gram_joint")}
    assert all(p.parent == tmp_path / "_build" for p in before.values())
    header = csrc / "fourier_basis.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda_build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert _cuda_build.library_path("fourier_gram") == after["fourier_gram"]


# -- the step --------------------------------------------------------------
def _bench_cm(ref):
    model, bundle, _ = state_from_numpy(load_state(ref, "bench"), device="cpu")
    return model.compile(bundle)


def _step(step, *args):
    dx, (covn, _), chi2, _ = step(*args, normalized_cov=True)
    return dx.numpy(), covn.numpy(), float(chi2)


def test_noise_fourier_spec_matches_the_basis(ref):
    """The spec's phi is the basis route's phi, bitwise, and its
    frequencies are the harmonics of the span."""
    cm = _bench_cm(ref)
    x0 = cm.x0()
    t_sec, freqs, phi = cm.noise_fourier_spec(x0)
    T, phi_b = cm.noise_basis_or_empty(x0)
    assert torch.equal(phi, phi_b)
    assert freqs.shape == (30,) and t_sec.shape == (512,)
    tspan = float(torch.max(t_sec) - torch.min(t_sec))
    assert float(freqs[4]) == pytest.approx(5.0 / tspan, rel=1e-15)


@pytest.mark.parametrize("against", ["reference", "port_f64"])
def test_fourier_step_on_bench_state(ref, against):
    """The port's streaming-basis step on the bench state at 512 TOAs.
    Against the reference's fourier step: dx 1e-3 of the largest
    component, chi2 1e-6 relative, normalized covariance 1e-3.  The dx
    bound is 1e-3, not 1e-4, because the reference sums its white Gram
    G_XX in f32 (gram32), which puts its own fourier step 3.7e-4 off its
    f64 step here, while the port's f64 sums (fitting/gls.py::_white_gram)
    sit 1.8e-6 off it (PERF.md).  Against the port's f64 step: the
    reference's step gates 2e-3, 1e-3, 5e-3."""
    cm = _bench_cm(ref)
    x0 = cm.x0()
    r = cm.time_residuals(x0, subtract_mean=False)
    M = design_with_offset(cm, x0)
    Nd = torch.square(cm.scaled_sigma(x0))
    dx, covn, chi2 = _step(gls_step_woodbury_fourier, r, M, Nd,
                           *cm.noise_fourier_spec(x0))
    if against == "reference":
        want = (ref["step/fourier/dx"], ref["step/fourier/covn"],
                float(ref["step/fourier/chi2"]))
        gates = (1e-3, 1e-6, 1e-3)
    else:
        want = _step(gls_step_woodbury, r, M, Nd,
                     *cm.noise_basis_or_empty(x0))
        gates = (2e-3, 1e-3, 5e-3)
    assert _rel(dx, want[0]) <= gates[0]
    assert abs(chi2 - want[2]) <= gates[1] * abs(want[2])
    assert _rel(covn, want[1]) <= gates[2]


@pytest.mark.parametrize("step", ["f64", "mixed"])
def test_ecorr_steps_match_reference(ref, step):
    """The ported EcorrNoise basis (ECORR epochs stacked before the
    red-noise harmonics) through both steps, against the reference's on
    the same state: the f64 step within 1e-8, the mixed step within the
    step gates 2e-3, 1e-3, 5e-3."""
    model, bundle, _ = state_from_numpy(load_state(ref, "ecorr_state"),
                                        device="cpu")
    cm = model.compile(bundle)
    x0 = cm.x0()
    T, phi = cm.noise_basis_or_empty(x0)
    assert T.shape[1] > 16 and cm.noise_fourier_spec(x0) is None
    fn = gls_step_woodbury if step == "f64" else gls_step_woodbury_mixed
    dx, covn, chi2 = _step(fn, cm.time_residuals(x0, subtract_mean=False),
                           design_with_offset(cm, x0),
                           torch.square(cm.scaled_sigma(x0)), T, phi)
    gates = (1e-8, 1e-9, 1e-8) if step == "f64" else (2e-3, 1e-3, 5e-3)
    assert _rel(dx, ref[f"ecorr/{step}/dx"]) <= gates[0]
    want = float(ref[f"ecorr/{step}/chi2"])
    assert abs(chi2 - want) <= gates[1] * abs(want)
    assert _rel(covn, ref[f"ecorr/{step}/covn"]) <= gates[2]


# -- the fitter and its ladder --------------------------------------------
def _fit_state(ref):
    return state_from_numpy(load_state(ref, "fit_state"), device="cpu")


@pytest.mark.parametrize("against", ["reference", "port_f64"])
def test_glsfitter_fused_matches(ref, against):
    """GLSFitter(fused=True), 3 iterations, on the fused-fit test's pulsar,
    with that test's criteria: chi2 1e-3 relative, values within 2e-2
    sigma, uncertainties 1e-2 relative; against the reference's fused fit
    and against the port's own f64 fit."""
    model, bundle, _ = _fit_state(ref)
    f = GLSFitter(bundle, model, device="cpu", fused=True)
    chi2 = f.fit_toas(maxiter=3)
    assert f.mode == "fourier" and f.guard_report.rung == "cpu-fourier"
    assert not f.guard_report.fell_back
    if against == "reference":
        want_chi2 = float(ref["fit/chi2"])
        vals, uncs = ref["fit/values"], ref["fit/uncs"]
        assert json.loads(str(ref["fit/report"]))["rung"] == "cpu-fourier"
    else:
        m64, b64, _ = _fit_state(ref)
        f64 = GLSFitter(b64, m64, device="cpu", fused=False)
        want_chi2 = f64.fit_toas(maxiter=3)
        vals = [float(m64.params[n].value) for n in f64.cm.free_names]
        uncs = [m64.params[n].uncertainty for n in f64.cm.free_names]
    assert chi2 == pytest.approx(want_chi2, rel=1e-3)
    for n, v, s in zip(f.cm.free_names, vals, uncs):
        p = model.params[n]
        assert abs(float(p.value) - v) < 2e-2 * s, n
        assert p.uncertainty == pytest.approx(s, rel=1e-2), n


def test_fused_true_refuses_ecorr_model():
    """fused=True needs exactly one pure-Fourier correlated basis: the
    ECORR + red-noise model raises PintTpuError, as in the reference."""
    model, toas = make_test_pulsar(ECORR_PAR, ntoa=240, seed=7, device="cpu")
    f = GLSFitter(toas, model, device="cpu", fused=True)
    with pytest.raises(PintTpuError, match="pure-Fourier"):
        f.fit_toas(maxiter=2)


def test_fit_rungs_have_no_cpu_rung():
    """The native mode, then f64 on the same device; nothing after."""
    assert fit_rungs("fourier", "cuda") == [("cuda-fourier", "fourier"),
                                            ("cuda-f64", "f64")]
    assert fit_rungs("f64", "cuda") == [("cuda-f64", "f64")]
    assert fit_rungs("mixed", "cpu") == [("cpu-mixed", "mixed"),
                                         ("cpu-f64", "f64")]


def test_ladder_falls_to_f64_on_nan(ref, monkeypatch):
    """A native fourier step with a NaN chi2 drops the fit to the f64
    rung; the report names it, and its history is the reference's on the
    same injected failure, string for string."""
    monkeypatch.setattr(gls, "gls_step_woodbury_fourier",
                        _poison_chi2(gls.gls_step_woodbury_fourier))
    model, bundle, _ = _fit_state(ref)
    f = GLSFitter(bundle, model, device="cpu", fused=True)
    with pytest.warns(GuardTripWarning, match="cpu-fourier"):
        chi2 = f.fit_toas(maxiter=3)
    rep = f.guard_report
    assert rep.rung == "cpu-f64" and rep.fell_back and rep.rung_index == 1
    assert rep.history[0][0] == "cpu-fourier"
    assert rep.history[0][1].startswith("PintTpuNumericsError: ")
    assert math.isfinite(chi2) and f.mode == "fourier"
    want = json.loads(str(ref["ladder/report"]))
    assert rep.to_dict() == want


def test_ladder_exhausted_when_every_rung_fails(monkeypatch):
    """Both rungs NaN: LadderExhausted, with both rungs in its history."""
    model, toas = make_test_pulsar(FIT_PAR, ntoa=64, seed=6, device="cpu")
    # every rung's step is built by gls.step_from (GLSFitter._gn_step)
    monkeypatch.setattr(gls, "step_from", _poison_chi2(gls.step_from))
    f = GLSFitter(toas, model, device="cpu", fused=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardTripWarning)
        with pytest.raises(LadderExhausted) as info:
            f.fit_toas(maxiter=3)
    assert [h[0] for h in info.value.history] == ["cpu-fourier", "cpu-f64"]
    assert f.guard_report is None


def test_ladder_propagates_other_errors(monkeypatch):
    """A failure that is not a numerics error (a failed kernel launch)
    propagates at once: the f64 rung never runs."""
    model, toas = make_test_pulsar(FIT_PAR, ntoa=64, seed=6, device="cpu")
    f64_calls = []

    def launch_fails(*a, **k):
        raise RuntimeError("fourier_gram kernel launch failed: cudaError 9")

    def counted_f64(*a, **k):
        f64_calls.append(1)
        return gls_step_woodbury(*a, **k)

    monkeypatch.setattr(gls, "gls_step_woodbury_fourier", launch_fails)
    monkeypatch.setattr(gls, "gls_step_woodbury", counted_f64)
    f = GLSFitter(toas, model, device="cpu", fused=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        f.fit_toas(maxiter=3)
    assert f64_calls == []


# -- on the card -----------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _gram_case(n, k, p, dev, seed=0):
    rng = np.random.default_rng(seed)
    tspan = 3.89e8
    return (torch.as_tensor(np.sort(rng.uniform(0, tspan, n)), device=dev),
            torch.as_tensor(np.arange(1, k + 1) / tspan, device=dev),
            torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev),
            torch.as_tensor(rng.standard_normal((n, p)), device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,p", [(100_000, 30, 7), (1000, 5, 3),
                                   (4099, 64, 16), (100_000, 64, 16)])
def test_fourier_gram_kernel_matches_plain_on_card(n, k, p):
    """The CUDA kernel against its plain version on the same card
    tensors: 3e-6 of scale, and bitwise equal to itself on a rerun."""
    t, f, w, X = _gram_case(n, k, p, _card())
    got = fourier.fourier_gram_cuda(t, f, w, X)
    again = fourier.fourier_gram_cuda(t, f, w, X)
    want = fourier.fourier_gram_plain(t, f, w, X)
    for g, g2, ww in zip(got, again, want):
        assert torch.equal(g, g2)
        scale = float(torch.max(torch.abs(ww)))
        assert float(torch.max(torch.abs(g - ww))) <= 3e-6 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,m", [(100_000, 30, 1), (100_000, 30, 8),
                                   (1001, 7, 3), (100_000, 64, 16)])
def test_fourier_apply_kernel_matches_plain_on_card(n, k, m):
    """As above for fourier_apply (f32 output)."""
    t, f, _, _ = _gram_case(n, k, 1, _card())
    z = torch.as_tensor(np.random.default_rng(1).standard_normal((2 * k, m)),
                        device=t.device)
    got = fourier.fourier_apply_cuda(t, f, z)
    again = fourier.fourier_apply_cuda(t, f, z)
    want = fourier.fourier_apply_plain(t, f, z)
    assert torch.equal(got, again)
    scale = float(torch.max(torch.abs(want)))
    assert float(torch.max(torch.abs(got - want))) <= 3e-6 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(100_000, 30), (999, 7), (4099, 64)])
def test_kernel_basis_is_basis32_on_card(n, k):
    """The generated basis (csrc/fourier_basis.cuh, shared by both
    kernels) bit for bit: fourier_apply_cuda with z a block of identity
    columns equals the matching columns of basis32 on the card."""
    t, f, _, _ = _gram_case(n, k, 1, _card())
    T = fourier.basis32(t, f)
    for c, Z in _identity_blocks(2 * k):
        got = fourier.fourier_apply_cuda(t, f, Z.to(t.device))
        assert torch.equal(got, T[:, c:c + Z.shape[1]]), c


@pytest.mark.gpu
def test_fused_fit_on_card_goes_through_the_kernel():
    """On the card fused=True is served by the cuda-fourier rung and every
    step launches fourier_gram once, fused_gram_joint never."""
    from pint_tpu_torch.ops import fused_gram

    dev = _card()
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=4096, seed=0, orbit=True,
                                   device=dev)
    f = GLSFitter(toas, model, device=dev, fused=True)
    before = (fourier.fourier_gram_cuda.launches,
              fused_gram.fused_gram_joint_cuda.launches)
    chi2 = f.fit_toas(maxiter=3)
    assert f.mode == "fourier" and math.isfinite(chi2)
    assert f.guard_report.rung == "cuda-fourier"
    # every step a replay of the step program, whose capture's warm-up
    # call launched the kernel once more
    assert f.cm.programs.replays == f.steps_taken
    assert fourier.fourier_gram_cuda.launches - before[0] == (
        f.steps_taken + f.cm.programs.captures)
    assert fused_gram.fused_gram_joint_cuda.launches == before[1]
