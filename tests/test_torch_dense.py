"""Parity of the port's dense-covariance GLS step with the JAX package.

``models/noise.py::dense_noise_cov`` and ``CompiledModel.noise_covariance``,
``ops/ffgram.py::matmul_split32`` and ``woodbury_chol_solve_ir``,
``parallel/dense.py::blocked_cholesky`` and ``fast_cholesky32``,
``fitting/gls.py::gls_step_full_cov`` in both methods, and ``full_cov=True``
in the four fitters (``GLSFitter``, ``DownhillGLSFitter`` on golden1's red
noise; ``WidebandTOAFitter``, ``WidebandDownhillFitter`` on golden17),
against the reference's on the same inputs: seeded numpy arrays, or a
golden's state exported by the reference, which runs once for the module
in a subprocess (tests/torch_reference.py).  Tolerances are stated per
test; the step gates are the reference's (dx 2e-3 of the largest
component, chi2 1e-3 relative, normalized covariance 5e-3).
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
from pint_tpu_torch.fitting import (  # noqa: E402
    DownhillGLSFitter,
    GLSFitter,
    WidebandDownhillFitter,
    WidebandTOAFitter,
)
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    gls_step_full_cov,
    gls_step_woodbury,
)
from pint_tpu_torch.models.noise import dense_noise_cov  # noqa: E402
from pint_tpu_torch.ops import solve_policy  # noqa: E402
from pint_tpu_torch.ops.ffgram import (  # noqa: E402
    chol_solve_ir,
    matmul_split32,
    woodbury_chol_solve_ir,
)
from pint_tpu_torch.parallel.dense import (  # noqa: E402
    blocked_cholesky,
    fast_cholesky32,
)

DATADIR = Path(__file__).parent / "datafile"
#: (fitter, golden) of the full_cov fit parity cases
FIT_CASES = [("GLSFitter", "golden1"), ("DownhillGLSFitter", "golden1"),
             ("WidebandTOAFitter", "golden17"),
             ("WidebandDownhillFitter", "golden17")]
STEMS = ["golden1", "golden17"]
CLASSES = {"GLSFitter": GLSFitter, "DownhillGLSFitter": DownhillGLSFitter,
           "WidebandTOAFitter": WidebandTOAFitter,
           "WidebandDownhillFitter": WidebandDownhillFitter}


def woodbury_inputs(n=400, k=30, p=6, seed=3):
    """(r, M, Ndiag, T, phi) of a red-noise-like problem: a Fourier-like
    basis of 30 columns with power-law weights over ten decades (the
    largest 100 times the white variances, ~1e-12 s^2) and design
    columns spanning ten decades."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 3e8, n))
    f = np.arange(1, k // 2 + 1) / 3e8
    T = np.concatenate([np.sin(2 * np.pi * t[:, None] * f),
                        np.cos(2 * np.pi * t[:, None] * f)], axis=1)
    phi = 1e-10 * np.logspace(0, -10, k)
    Ndiag = 1e-12 * rng.uniform(0.5, 2.0, n)
    M = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, p - 1))
                        * np.logspace(0, 10, p - 1)], axis=1)
    r = 1e-6 * rng.standard_normal(n)
    return r, M, Ndiag, T, phi


def spd_inputs(n=1000, seed=4):
    """A dense SPD matrix of a unit diagonal plus a rank-40 red part
    (an equilibrated covariance) and a right-hand side (n, 3)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((n, 40)) * np.logspace(0, -2, 40)
    C = W @ W.T
    d = 1.0 / np.sqrt(np.diag(C) + 1.0)
    C = (C + np.eye(n)) * np.outer(d, d)
    return C, rng.standard_normal((n, 3))


_SCRIPT = textwrap.dedent(f"""
import warnings
import jax.numpy as jnp
import test_torch_dense as t
from pint_tpu.fitting import DownhillGLSFitter, GLSFitter
from pint_tpu.fitting.base import design_with_offset
from pint_tpu.fitting.gls import gls_step_full_cov
from pint_tpu.fitting.wideband import (WidebandDownhillFitter,
                                       WidebandTOAFitter)
from pint_tpu.models.builder import get_model_and_toas
from pint_tpu.models.noise import dense_noise_cov
from pint_tpu.models.timing_model import reference_values
from pint_tpu.ops.ffgram import (chol_solve_ir, matmul_split32,
                                 woodbury_chol_solve_ir)
from pint_tpu.parallel.dense import blocked_cholesky, fast_cholesky32
from pint_tpu.timebase.hostdd import HostDD


def load(stem):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model_and_toas(f"tests/datafile/{{stem}}.par",
                                  f"tests/datafile/{{stem}}.tim")


def internal(model, names):
    ref = reference_values(model)
    return np.array([[ref[n].hi, ref[n].lo] if isinstance(ref[n], HostDD)
                     else [ref[n], 0.0] for n in names], float)


r, M, Nd, T, phi = (jnp.asarray(a) for a in t.woodbury_inputs())
OUT["cov"] = np.asarray(dense_noise_cov(Nd, T, phi))
OUT["split"] = np.asarray(matmul_split32(M.T, T))
X = jnp.concatenate([M, r[:, None]], axis=1)
OUT["wood"] = np.asarray(woodbury_chol_solve_ir(Nd, T, phi, X,
                                                check_rtol=1e-5))
C, B = (jnp.asarray(a) for a in t.spd_inputs())
OUT["blocked"] = np.asarray(blocked_cholesky(C, block=256, lookahead=False))
OUT["fast_solve"] = np.asarray(chol_solve_ir(C, B, cholesky=fast_cholesky32,
                                             check_rtol=1e-5))

model, toas = load("golden1")
cm = model.compile(toas)
export_state(cm, "golden1")
x0 = cm.x0()
OUT["noise_cov"] = np.asarray(cm.noise_covariance(x0))
args = (cm.time_residuals(x0, subtract_mean=False),
        design_with_offset(cm, x0), jnp.square(cm.scaled_sigma(x0)),
        *cm.noise_basis_or_empty(x0))
for i, a in enumerate(args):
    OUT[f"args/{{i}}"] = np.asarray(a)
for method in ("f64", "mixed"):
    if method == "mixed":
        os.environ["PINT_TPU_SOLVE_IR"] = "force"
    dx, (covn, norm), chi2, _ = gls_step_full_cov(*args, method=method,
                                                  normalized_cov=True)
    os.environ.pop("PINT_TPU_SOLVE_IR", None)
    OUT[f"step/{{method}}/dx"] = np.asarray(dx)
    OUT[f"step/{{method}}/covn"] = np.asarray(covn)
    OUT[f"step/{{method}}/chi2"] = np.asarray(chi2)

m17, t17 = load("golden17")
export_state(m17.compile(t17), "golden17")
classes = dict(GLSFitter=GLSFitter, DownhillGLSFitter=DownhillGLSFitter,
               WidebandTOAFitter=WidebandTOAFitter,
               WidebandDownhillFitter=WidebandDownhillFitter)
for cls, stem in {FIT_CASES!r}:
    model, toas = load(stem)
    f = classes[cls](toas, model, full_cov=True)
    if cls in ("GLSFitter", "WidebandTOAFitter"):
        step, x, chis = f._make_step("full_cov"), f.cm.x0(), []
        for _ in range(4):
            dx, _, chi2, _ = step(x)
            x = x + dx[f._noffset:]
            chis.append(float(chi2))
        OUT[f"fit/{{cls}}/steps"] = np.array(chis)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas()
    key = f"fit/{{cls}}"
    OUT[key + "/chi2"] = np.asarray(chi2)
    OUT[key + "/converged"] = np.asarray(f.converged)
    OUT[key + "/internal"] = internal(model, f.cm.free_names)
    OUT[key + "/cov"] = np.asarray(f.parameter_covariance_matrix)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    return run_reference(_SCRIPT, d / "dense.npz", timeout=900)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _args(ref):
    return tuple(_t(ref[f"args/{i}"]) for i in range(5))


# -- the assembly and the split product --------------------------------------
def test_dense_noise_cov_matches_reference(ref):
    """diag(N) + T phi T^T (the product, then N added to its diagonal in
    place) within 1e-12 relative of the reference's."""
    _, _, Nd, T, phi = (_t(a) for a in woodbury_inputs())
    C = dense_noise_cov(Nd, T, phi)
    assert _rel(C, ref["cov"]) <= 1e-12
    assert torch.equal(dense_noise_cov(Nd, None, None), torch.diag(Nd))


def test_noise_covariance_matches_reference(ref):
    """CompiledModel.noise_covariance on golden1's state (ELL1, red
    noise, EFAC) within 1e-12 relative of the reference's."""
    model, bundle, _ = state_from_numpy(load_state(ref, "golden1"),
                                        device="cpu")
    cm = model.compile(bundle, device="cpu")
    assert _rel(cm.noise_covariance(cm.x0()), ref["noise_cov"]) <= 1e-12


def test_matmul_split32(ref):
    """M^T T (400 rows, columns over ten decades) through the two-term f32
    split: within 1e-6 of the f64 product relative to the summed terms'
    magnitudes (each 128-row chunk sums in f32, at most ~128 eps32 / 2 =
    3.8e-6 and in practice a few 1e-7), and within 1e-12 of the
    reference's (the same f32 products summed in f64)."""
    _, M, _, T, _ = (_t(a) for a in woodbury_inputs())
    got = matmul_split32(M.T, T)
    terms = torch.abs(M.T) @ torch.abs(T)
    assert float(torch.max(torch.abs(got - M.T @ T) / terms)) <= 1e-6
    assert float(torch.max(torch.abs(got - _t(ref["split"])) / terms)) <= 1e-12


# -- the refined solves --------------------------------------------------------
def test_woodbury_chol_solve_ir(ref):
    """C^-1 [M | r] at n = 400, k = 30, phi over ten decades, the residual
    check armed: within 1e-9 relative of the dense f64 solve and of the
    reference's."""
    r, M, Nd, T, phi = (_t(a) for a in woodbury_inputs())
    X = torch.cat([M, r[:, None]], dim=1)
    got = woodbury_chol_solve_ir(Nd, T, phi, X, check_rtol=1e-5)
    exact = torch.linalg.solve(dense_noise_cov(Nd, T, phi), X)
    assert torch.all(torch.isfinite(got))
    assert _rel(got, exact.numpy()) <= 1e-9
    assert _rel(got, ref["wood"]) <= 1e-9


def test_blocked_cholesky(ref):
    """f64 at n = 1000 with block 256 (padded to 1024) and both panel
    rules: within 1e-12 relative of torch.linalg.cholesky and of the
    reference's sequential schedule."""
    C, _ = spd_inputs()
    C = _t(C)
    want = torch.linalg.cholesky(C)
    for panel in ("solve", "inv"):
        L = blocked_cholesky(C, block=256, panel=panel)
        assert L.shape == C.shape
        assert torch.equal(L, torch.tril(L))
        assert _rel(L, want.numpy()) <= 1e-12, panel
        assert _rel(L, ref["blocked"]) <= 1e-12, panel
    bumped = blocked_cholesky(C, block=256, diag_bump=1e-3)
    assert _rel(bumped, torch.linalg.cholesky(
        C + 1e-3 * torch.eye(1000, dtype=torch.float64)).numpy()) <= 1e-12


def test_fast_cholesky32_refined_solve(ref):
    """chol_solve_ir with fast_cholesky32's f32 factor (ridge 3e-5) as the
    preconditioner: within 1e-9 relative of the native factor's refined
    solve and of the reference's (the ridge perturbs the preconditioner
    by 3e-5, so two refinement sweeps leave ~(3e-5 cond)^3); a NaN
    operand poisons the factor from its diagonal block on."""
    C, B = (_t(a) for a in spd_inputs())
    got = chol_solve_ir(C, B, cholesky=fast_cholesky32, check_rtol=1e-5)
    native = chol_solve_ir(C, B, check_rtol=1e-5)
    assert torch.all(torch.isfinite(got))
    assert _rel(got, native.numpy()) <= 1e-9
    assert _rel(got, ref["fast_solve"]) <= 1e-9
    bad = C.to(torch.float32).clone()
    bad[700, 700] = float("nan")
    L = fast_cholesky32(bad)  # block 512: the NaN is in the second block
    assert torch.all(torch.isfinite(L[:512]))
    assert torch.all(torch.isnan(L[512:, 512:].diagonal()))


def test_ir_cholesky_policy(monkeypatch):
    """The refined solves' factor by size: native below IR_BLOCKED_MIN (or
    everywhere when it is None, or with the policy off), fast_cholesky32
    at or above it."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(solve_policy, "IR_BLOCKED_MIN", 4096)
    assert solve_policy.ir_cholesky(4095, cuda) is None
    assert solve_policy.ir_cholesky(4096, cuda) is fast_cholesky32
    assert solve_policy.ir_cholesky(4096, "cpu") is None
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "0")
    assert solve_policy.ir_cholesky(8192, cuda) is None
    monkeypatch.setattr(solve_policy, "IR_BLOCKED_MIN", None)
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    assert solve_policy.ir_cholesky(1 << 20, "cpu") is None


# -- the dense step -------------------------------------------------------------
def _step(args, method):
    dx, (covn, _), chi2, _ = gls_step_full_cov(*args, method=method,
                                               normalized_cov=True)
    return dx.numpy(), covn.numpy(), float(chi2)


def test_full_cov_f64_step_matches_reference(ref):
    """method='f64' on golden1's step inputs (the reference's arrays): dx
    within 1e-10 of its largest component, chi2 1e-10 relative, the
    normalized covariance 1e-10, against the reference's f64 dense step;
    method=None on the CPU is the same call."""
    args = _args(ref)
    dx, covn, chi2 = _step(args, "f64")
    assert _rel(dx, ref["step/f64/dx"]) <= 1e-10
    assert chi2 == pytest.approx(float(ref["step/f64/chi2"]), rel=1e-10)
    assert _rel(covn, ref["step/f64/covn"]) <= 1e-10
    again = _step(args, None)
    assert np.array_equal(again[0], dx) and again[2] == chi2


def test_full_cov_mixed_step_matches_reference(ref, monkeypatch):
    """method='mixed' (the card's route, forced on the CPU with the
    residual check armed) on golden1's step inputs: within the step gates
    of the reference's mixed dense step and of the f64 dense step."""
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    dx, covn, chi2 = _step(_args(ref), "mixed")
    for method in ("mixed", "f64"):
        assert _rel(dx, ref[f"step/{method}/dx"]) <= 2e-3, method
        assert chi2 == pytest.approx(float(ref[f"step/{method}/chi2"]),
                                     rel=1e-3), method
        assert _rel(covn, ref[f"step/{method}/covn"]) <= 5e-3, method


def test_full_cov_step_matches_woodbury_step(ref, monkeypatch):
    """The dense step is the reduced-rank step's C = N + T phi T^T,
    factored whole: the f64 dense step within 1e-9 of the f64 Woodbury
    step (dx of its largest component, chi2 and covariance relative), the
    mixed dense step within the step gates; the mixed step with T None
    (pure white) through chol_solve_ir of the dense diagonal, within the
    gates of the f64 step of the same white covariance."""
    args = _args(ref)
    dx_w, (cov_w, _), chi2_w, _ = gls_step_woodbury(*args,
                                                    normalized_cov=True)
    dx, covn, chi2 = _step(args, "f64")
    assert _rel(dx, dx_w.numpy()) <= 1e-9
    assert chi2 == pytest.approx(float(chi2_w), rel=1e-9)
    assert _rel(covn, cov_w.numpy()) <= 1e-9
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    dx, covn, chi2 = _step(args, "mixed")
    assert _rel(dx, dx_w.numpy()) <= 2e-3
    assert chi2 == pytest.approx(float(chi2_w), rel=1e-3)
    assert _rel(covn, cov_w.numpy()) <= 5e-3
    r, M, Nd = args[:3]
    white = _step((r, M, Nd, None, None), "mixed")
    want = _step((r, M, Nd, None, None), "f64")
    assert _rel(white[0], want[0]) <= 2e-3
    assert white[2] == pytest.approx(want[2], rel=1e-3)


# -- full_cov=True in the four fitters ----------------------------------------
def _internal(model, names):
    out = []
    for n in names:
        v = model.params[n].internal()
        out.append([v.hi, v.lo] if hasattr(v, "hi") else [float(v), 0.0])
    return np.array(out, float)


@pytest.mark.parametrize("cls,stem", FIT_CASES)
def test_full_cov_fits(ref, cls, stem):
    """Each fitter with full_cov=True on the golden's state (the dense
    step's f64 method on the CPU) at tests/test_golden_regression.py's
    criteria against the oracle (chi2 1e-6 relative, values within 1e-3
    sigma, uncertainties 1e-6 relative) and against the reference's same
    fitter: values within 1e-8 relative or 1e-6 sigma
    (tests/test_torch_fit_layer.py's parity), chi2 1e-8, and for the
    downhill fitters the same converged flag.  The iterated fitters'
    chi2 moves ~1e-9 relative from step to step on these goldens, about
    the 1e-10 convergence tolerance, in both packages: there the four
    eager dense steps' chi2 are held to the reference's eager steps'
    within 1e-12 relative instead of the jitted loop's flag."""
    key = f"fit/{cls}"
    if cls in ("GLSFitter", "WidebandTOAFitter"):
        m0, b0, _ = state_from_numpy(load_state(ref, stem), device="cpu")
        g = CLASSES[cls](b0, m0, True, device="cpu")
        x, chis = g.cm.x0(), []
        for _ in range(4):
            x, _, c, _ = g._gn_step(x, "full_cov")
            chis.append(float(c))
        np.testing.assert_allclose(chis, ref[key + "/steps"], rtol=1e-12)
    model, bundle, _ = state_from_numpy(load_state(ref, stem), device="cpu")
    f = CLASSES[cls](bundle, model, True, device="cpu")
    assert f.full_cov
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas()
    if cls in ("GLSFitter", "WidebandTOAFitter"):
        assert f.mode == "full_cov"
        assert f.guard_report.rung == "cpu-full_cov"
    else:
        assert f.guard_report.rung == "native"
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    assert chi2 == pytest.approx(float(oracle["chi2"]), rel=1e-6)
    for name, val, unc in zip(oracle["names"], oracle["values"],
                              oracle["uncs"]):
        p = model.params[str(name)]
        v = p.value
        v = float(v.to_float()) if hasattr(v, "to_float") else float(v)
        assert abs(v - val) < 1e-3 * unc, name
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), name
    if cls not in ("GLSFitter", "WidebandTOAFitter"):
        assert f.converged == bool(ref[key + "/converged"])
    assert chi2 == pytest.approx(float(ref[key + "/chi2"]), rel=1e-8)
    got = _internal(model, f.cm.free_names)
    want = ref[key + "/internal"]
    diff = np.abs((got[:, 0] - want[:, 0]) + (got[:, 1] - want[:, 1]))
    sig = np.sqrt(np.diag(f.parameter_covariance_matrix))
    ok = diff <= np.maximum(1e-8 * np.abs(want[:, 0]), 1e-6 * sig)
    assert np.all(ok), dict(zip(f.cm.free_names, diff / sig))


def test_full_cov_fitter_steps_are_dense(ref, monkeypatch):
    """The fitters' full_cov steps are gls_step_full_cov: GLSFitter's
    step on golden1 equals the dense f64 step of its own inputs bit for
    bit, DownhillGLSFitter's proposal its dx; fused=False pins f64 and
    fused=True or 'mixed' raises the reference's PintTpuError."""
    from pint_tpu_torch.exceptions import PintTpuError
    from pint_tpu_torch.fitting.base import design_with_offset

    model, bundle, _ = state_from_numpy(load_state(ref, "golden1"),
                                        device="cpu")
    f = GLSFitter(bundle, model, full_cov=True, fused=False, device="cpu")
    assert f._full_cov_method() == "f64"
    x0 = f.cm.x0()
    xn, (covn, _), chi2, _ = f._gn_step(x0, "full_cov")
    cm = f.cm
    args = (cm.time_residuals(x0, subtract_mean=False),
            design_with_offset(cm, x0), torch.square(cm.scaled_sigma(x0)),
            *cm.noise_basis_or_empty(x0))
    dx, (covd, _), chi2d, _ = gls_step_full_cov(*args, method="f64",
                                                normalized_cov=True)
    assert torch.equal(xn, x0 + dx[1:])
    assert torch.equal(covn, covd) and torch.equal(chi2, chi2d)
    d = DownhillGLSFitter(bundle, model, True, device="cpu")
    pdx, _, _, _ = d._make_proposal()(x0)
    assert torch.equal(pdx, dx[1:])
    for fused in (True, "mixed"):
        with pytest.raises(PintTpuError, match="mutually exclusive"):
            GLSFitter(bundle, model, True, fused, device="cpu")


# -- on the card ------------------------------------------------------------------
def _card_pulsar(ntoa=2048):
    from torch_reference import BENCH_PAR

    from pint_tpu_torch.simulation import make_test_pulsar

    # the 1-AU orbit, as chip_smoke.py's SIM: without it the astrometry
    # columns are zero and the refined p x p solve refuses them
    return make_test_pulsar(BENCH_PAR, ntoa=ntoa, seed=0, device="cpu",
                            start_mjd=53000.0, end_mjd=57500.0,
                            iterations=1, orbit=True)


@pytest.mark.gpu
def test_full_cov_step_card_matches_cpu():
    """bench.py's pulsar at 2048 TOAs: the f64 dense step on the card
    within 1e-8 relative of the CPU's (dx, chi2, covariance), and the
    card's mixed dense step (its default) within the step gates of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, toas = _card_pulsar()
    out = {}
    for dev in ("cpu", "cuda"):
        f = GLSFitter(toas, model, full_cov=True, device=dev)
        x0 = f.cm.x0()
        args = (*f._step_inputs(x0), *f._step_noise(x0))
        for method in ("f64", None):
            dx, (covn, _), chi2, _ = gls_step_full_cov(
                *args, method=method, normalized_cov=True)
            out[dev, method] = (dx.cpu(), covn.cpu(), float(chi2))
    want = out["cpu", "f64"]
    got = out["cuda", "f64"]
    assert _rel(got[0], want[0].numpy()) <= 1e-8
    assert _rel(got[1], want[1].numpy()) <= 1e-8
    assert got[2] == pytest.approx(want[2], rel=1e-8)
    mixed = out["cuda", None]
    assert _rel(mixed[0], want[0].numpy()) <= 2e-3
    assert mixed[2] == pytest.approx(want[2], rel=1e-3)
    assert _rel(mixed[1], want[1].numpy()) <= 5e-3


@pytest.mark.gpu
def test_full_cov_fit_card_matches_cpu():
    """GLSFitter(full_cov=True, fused=False) at 2048 TOAs on the card, its
    steps replays of a captured step program, against the same fit on
    the CPU: chi2 and every value within 1e-8 relative or 1e-6 sigma."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from pint_tpu_torch.models.builder import get_model
    from torch_reference import BENCH_PAR

    _, toas = _card_pulsar()
    fits = {}
    for dev in ("cpu", "cuda"):
        model = get_model(BENCH_PAR)
        f = GLSFitter(toas, model, full_cov=True, fused=False, device=dev)
        chi2 = f.fit_toas(maxiter=3)
        fits[dev] = (f, chi2, _internal(model, f.cm.free_names))
    card, cpu = fits["cuda"], fits["cpu"]
    assert card[0].guard_report.rung == "cuda-full_cov"
    assert card[1] == pytest.approx(cpu[1], rel=1e-8)
    diff = np.abs((card[2][:, 0] - cpu[2][:, 0])
                  + (card[2][:, 1] - cpu[2][:, 1]))
    sig = np.sqrt(np.diag(cpu[0].parameter_covariance_matrix))
    assert np.all(diff <= np.maximum(1e-8 * np.abs(cpu[2][:, 0]),
                                     1e-6 * sig))
