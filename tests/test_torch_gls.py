"""Parity of the PyTorch port's GLS step and fitter with the JAX package.

The reference runs once per module in a subprocess (tests/torch_reference.py)
with ``PINT_TPU_FUSED_INTERIOR=force`` and ``PINT_TPU_SOLVE_IR=force``: its
mixed step then goes through the Pallas ``fused_gram_joint`` in interpret
mode and the refined solves, as on an accelerator.  The port's mixed step
is forced the same way with the ``PINT_TPU_TORCH_*`` knobs, so on the CPU
its joint Gram goes through the fused dispatcher's plain version.
"""

import math
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    BENCH_PAR,
    bench_build_script,
    golden13_script,
    load_state,
    run_reference,
)

import pint_tpu_torch.ops.fused_gram as fused_gram  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting import gls  # noqa: E402
from pint_tpu_torch.fitting.base import (  # noqa: E402
    ConvergenceFailure,
    design_with_offset,
    run_fit_loop,
)
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    default_accel_mode,
    gls_step_woodbury,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

STATES = ["bench", "golden13"]

_SCRIPT = textwrap.dedent("""
import warnings
import jax.numpy as jnp
from pint_tpu.fitting import GLSFitter
from pint_tpu.fitting.base import design_with_offset
from pint_tpu.fitting.gls import gls_step_woodbury, gls_step_woodbury_mixed

x0 = cm.x0()
args = (cm.time_residuals(x0, subtract_mean=False),
        design_with_offset(cm, x0), jnp.square(cm.scaled_sigma(x0)),
        *cm.noise_basis_or_empty(x0))
for name, step in (("f64", gls_step_woodbury),
                   ("mixed", gls_step_woodbury_mixed)):
    dx, (covn, nrm), chi2, _ = step(*args, normalized_cov=True)
    OUT[f"step/{name}/dx"] = np.asarray(dx)
    OUT[f"step/{name}/covn"] = np.asarray(covn)
    OUT[f"step/{name}/chi2"] = np.asarray(chi2)

for name, (m, t) in (("bench", (model, toas)), ("golden13", (g_model, g_toas))):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = GLSFitter(t, m, fused=False)
        OUT[f"fit/{name}/chi2"] = np.asarray(f.fit_toas(maxiter=3))
    names = list(f.cm.free_names)
    vals, uncs = [], []
    for n in names:
        p = m.params[n]
        v = p.value
        vals.append(float(v.to_float()) if hasattr(v, "to_float") else float(v))
        uncs.append(float(p.uncertainty))
    OUT[f"fit/{name}/values"] = np.array(vals)
    OUT[f"fit/{name}/uncs"] = np.array(uncs)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    script = bench_build_script(512) + golden13_script() + _SCRIPT
    return run_reference(
        script, tmp_path_factory.mktemp("ref") / "gls.npz",
        env={"PINT_TPU_FUSED_INTERIOR": "force",
             "PINT_TPU_SOLVE_IR": "force"},
    )


@pytest.fixture
def forced_mixed(monkeypatch):
    """The accelerator route on the CPU: fused interior + refined solves."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")


def _step_args(ref, name="bench"):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    cm = model.compile(bundle)
    x0 = cm.x0()
    T, phi = cm.noise_basis_or_empty(x0)
    return (cm.time_residuals(x0, subtract_mean=False),
            design_with_offset(cm, x0), torch.square(cm.scaled_sigma(x0)),
            T, phi)


def _step(step, args):
    dx, (covn, _nrm), chi2, _ = step(*args, normalized_cov=True)
    return dx.numpy(), covn.numpy(), float(chi2)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_f64_step_matches_reference(ref):
    """Exact-f64 Woodbury step: dx within 1e-8 of its largest component,
    chi2 within 1e-9 relative (roundoff of two f64 libraries)."""
    dx, covn, chi2 = _step(gls_step_woodbury, _step_args(ref))
    assert _rel(dx, ref["step/f64/dx"]) <= 1e-8
    assert abs(chi2 - float(ref["step/f64/chi2"])) <= 1e-9 * abs(chi2)
    assert _rel(covn, ref["step/f64/covn"]) <= 1e-8


@pytest.mark.parametrize("against", ["mixed", "f64"])
def test_mixed_step_within_bench_gates(ref, forced_mixed, monkeypatch,
                                       against):
    """The port's mixed step (fused dispatcher + refined solves) against
    the reference's mixed step and its f64 step, at bench.py's
    fused_interior gates: dx 2e-3 of the largest component, chi2 1e-3
    relative, normalized covariance 5e-3."""
    calls = []
    plain = fused_gram.fused_gram_joint

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(fused_gram, "fused_gram_joint", counted)
    dx, covn, chi2 = _step(gls_step_woodbury_mixed, _step_args(ref))
    assert calls == [(512, 60)]  # the joint Gram went through the kernel's route
    want = f"step/{against}"
    assert _rel(dx, ref[f"{want}/dx"]) <= 2e-3
    assert abs(chi2 - float(ref[f"{want}/chi2"])) <= 1e-3 * abs(chi2)
    assert _rel(covn, ref[f"{want}/covn"]) <= 5e-3


def test_mixed_step_unfused_hatch(ref, forced_mixed, monkeypatch):
    """PINT_TPU_TORCH_FUSED_INTERIOR=0 takes gram32_joint; both routes are
    the same f32-chunk class and agree far inside the gates."""
    args = _step_args(ref)
    fused = _step(gls_step_woodbury_mixed, args)
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "0")
    unfused = _step(gls_step_woodbury_mixed, args)
    assert _rel(fused[0], unfused[0]) <= 2e-3
    assert abs(fused[2] - unfused[2]) <= 1e-6 * abs(unfused[2])


@pytest.mark.parametrize("name", STATES)
def test_glsfitter_f64_matches_reference(ref, name):
    """GLSFitter(fused=False), 3 iterations, against the reference's, with
    the test_golden_fit criteria: chi2 1e-6 relative, values within
    1e-3 sigma, uncertainties 1e-6 relative."""
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    f = GLSFitter(model, bundle, device="cpu", fused=False)
    chi2 = f.fit_toas(maxiter=3)
    assert chi2 == pytest.approx(float(ref[f"fit/{name}/chi2"]), rel=1e-6)
    for n, val, unc in zip(f.cm.free_names, ref[f"fit/{name}/values"],
                           ref[f"fit/{name}/uncs"]):
        p = model.params[n]
        assert abs(float(p.value) - val) < 1e-3 * unc, n
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), n


def test_auto_mode_is_f64_on_cpu():
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=64, seed=1, orbit=True,
                                   device="cpu")
    f = GLSFitter(model, toas, device="cpu")
    assert default_accel_mode(f.cm) == "f64"
    chi2 = f.fit_toas(maxiter=2)
    assert f.mode == "f64" and math.isfinite(chi2)
    assert f.steps_taken == 2


def test_fit_loop_semantics():
    """chi2 is measured before each step; the loop stops after the step
    at which chi2 stops moving, and freezes on a non-finite chi2."""
    seq = iter([10.0, 5.0, 5.0, 1.0])
    x0 = torch.zeros(2, dtype=torch.float64)
    cov = (torch.eye(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64))

    def step(x):
        return x + 1, cov, torch.tensor(next(seq)), torch.tensor(0)

    x, chi2, _, conv, nbads, bad = run_fit_loop(step, x0, 3, 4, 1e-10)
    assert conv and not bad and chi2 == 5.0 and x.tolist() == [3.0, 3.0]
    assert nbads == [0, 0, 0]

    seq = iter([10.0, float("nan"), 1.0])
    x, chi2, _, conv, _, bad = run_fit_loop(step, x0, 3, 4, 1e-10)
    assert bad and not conv and chi2 == 10.0 and x.tolist() == [1.0, 1.0]


def test_nonfinite_chi2_raises(monkeypatch):
    """No fallback ladder: a non-finite chi2 raises."""
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=64, seed=1, orbit=True,
                                   device="cpu")
    f = GLSFitter(model, toas, device="cpu")
    real = gls.gauss_newton_step

    def poisoned(cm, x, mode):
        x2, cov, chi2, nbad = real(cm, x, mode)
        return x2, cov, chi2 * float("nan"), nbad

    monkeypatch.setattr(gls, "gauss_newton_step", poisoned)
    with pytest.raises(ConvergenceFailure):
        f.fit_toas(maxiter=3)


@pytest.mark.gpu
def test_glsfitter_on_card_goes_through_the_kernel():
    """On the card the auto mode is mixed and every step launches the
    fused CUDA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=4096, seed=0, orbit=True,
                                   device="cuda")
    f = GLSFitter(model, toas, device="cuda")
    before = fused_gram.fused_gram_joint_cuda.launches
    chi2 = f.fit_toas(maxiter=3)
    assert f.mode == "mixed" and math.isfinite(chi2)
    assert fused_gram.fused_gram_joint_cuda.launches - before == f.steps_taken
