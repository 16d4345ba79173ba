"""Parity of the port's O(append) streaming solver with the JAX package.

One port test for each test of ``tests/test_stream_state.py``, on the
same seeded inputs and at the same tolerances: ``ops/cholupdate.py``'s
rank-k factor updates (against a fresh factorization, the degenerate
shapes, the exact identity of zero columns, the NaN poison of a bad
pivot), ``factor_solve_ir`` (a stale factor refined, the poison check,
the empty factor) and the Gram-block state of ``fitting/gls.py``
(``stream_state_init``/``_append``/``_solve`` against the one-shot
Woodbury step, append against a fresh init, pad rows neutral, the offset
not committed, the drift poison's rollback, the f32 factor forced on the
CPU, the drift tolerance's knob).  Each is also held to the reference's
output on the same inputs where the reference test has one: the
reference runs once for the module in a subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.fitting import gls  # noqa: E402
from pint_tpu_torch.ops import solve_policy  # noqa: E402
from pint_tpu_torch.ops.cholupdate import (  # noqa: E402
    chol_factor_solve,
    chol_update,
    factor_solve_ir,
)


def _spd(k, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((k, k))
    return scale * (A @ A.T + k * np.eye(k))


def _problem_np(n=200, p=4, k=6, seed=0, pad=0):
    """test_stream_state._problem's synthetic GLS problem as numpy:
    (r, M, Ninv, T, phi), ``pad`` trailing rows of exactly zero Ninv."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, p)) * np.geomspace(1.0, 1e3, p)
    r = rng.standard_normal(n) * 1e-2
    Ninv = 1.0 / rng.uniform(0.5, 2.0, n)
    T = rng.standard_normal((n, k)) if k else np.zeros((n, 0))
    phi = rng.uniform(0.1, 10.0, k)
    if pad:
        Ninv[-pad:] = 0.0
    return r, M, Ninv, T, phi


def _problem(**kw):
    return tuple(torch.as_tensor(a) for a in _problem_np(**kw))


def _pad_tail():
    """The pad-row case's 30 garbage rows (test_stream_state's draw)."""
    rng = np.random.default_rng(23)
    return (rng.standard_normal(30) * 1e6,
            rng.standard_normal((30, 4)) * 1e6,
            rng.standard_normal((30, 6)) * 1e6)


def _offset_problem():
    """test_stream_solve_offset_profiled_not_committed's inputs."""
    rng = np.random.default_rng(24)
    n, p = 300, 4
    M = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, p - 1))],
                       axis=1)
    x_true = np.array([0.5, 1.0, -2.0, 0.3])
    r0 = M @ x_true + rng.standard_normal(n) * 1e-3
    return r0, M


_SCRIPT = textwrap.dedent("""
import jax.numpy as jnp
from pint_tpu.fitting import gls
from pint_tpu.ops import solve_policy
from pint_tpu.ops.cholupdate import (chol_factor_solve, chol_update,
                                     factor_solve_ir)
import test_torch_stream as t


def put(name, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(f"{name}/{k}", v)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            put(f"{name}/{i}", v)
    else:
        OUT[name] = np.asarray(tree)


def prob(**kw):
    return tuple(jnp.asarray(a) for a in t._problem_np(**kw))


A = t._spd(8, 1)
V = np.random.default_rng(2).standard_normal((8, 5))
put("update", chol_update(jnp.asarray(np.linalg.cholesky(A)),
                          jnp.asarray(V)))
L4 = jnp.asarray(np.linalg.cholesky(t._spd(6, 4)))
put("zero_cols", chol_update(L4, jnp.zeros((6, 3))))
L3 = jnp.asarray(np.linalg.cholesky(np.eye(3) * 1e-6)).at[0, 0].set(jnp.nan)
put("pivot", chol_update(L3, jnp.asarray([[10.0], [0.0], [0.0]])))
A5 = t._spd(5, 7)
B5 = np.random.default_rng(8).standard_normal((5, 2))
put("factor_solve", chol_factor_solve(
    jnp.asarray(np.linalg.cholesky(A5)), jnp.asarray(B5)))
A12 = t._spd(12, 9)
L12 = np.linalg.cholesky(A12).astype(np.float32).astype(np.float64)
B12 = np.random.default_rng(10).standard_normal((12, 3))
put("stale", factor_solve_ir(jnp.asarray(L12), jnp.asarray(A12),
                             jnp.asarray(B12), refine=2))
A6 = t._spd(6, 11)
B6 = np.random.default_rng(12).standard_normal((6, 2))
put("garbage", factor_solve_ir(jnp.asarray(np.tril(np.full((6, 6), 1e-12))),
                               jnp.asarray(A6), jnp.asarray(B6), refine=0,
                               check_rtol=1e-8))

for k in (0, 6):
    r, M, Ninv, T, phi = prob(k=k, seed=20)
    st = gls.stream_state_init(r, M, Ninv, T, phi, jnp.zeros(4))
    st2, dx, cov, chi2 = gls.stream_state_solve(st, 0)
    put(f"init/{k}", (dx, cov, chi2))
    put(f"init/{k}/again", gls.stream_state_solve(st2, 0)[1])

r, M, Ninv, T, phi = prob(n=300, k=6, seed=21)
st_full = gls.stream_state_init(r, M, Ninv, T, phi, jnp.zeros(4))
st = gls.stream_state_init(r[:240], M[:240], Ninv[:240], T[:240], phi,
                           jnp.zeros(4))
for lo, hi in ((240, 270), (270, 300)):
    st = gls.stream_state_append(st, r[lo:hi], M[lo:hi], Ninv[lo:hi],
                                 T[lo:hi])
put("append/state", st)
put("append/solve", gls.stream_state_solve(st, 0)[1:])
put("append/full", gls.stream_state_solve(st_full, 0)[1:])

r, M, Ninv, T, phi = prob(n=260, k=6, seed=22)
st = gls.stream_state_init(r[:200], M[:200], Ninv[:200], T[:200], phi,
                           jnp.zeros(4))
rg, Mg, Tg = (jnp.asarray(a) for a in t._pad_tail())
put("pad/live", gls.stream_state_append(
    st, r[200:230], M[200:230], Ninv[200:230], T[200:230]))
put("pad/padded", gls.stream_state_append(
    st, jnp.concatenate([r[200:230], rg]), jnp.concatenate([M[200:230], Mg]),
    jnp.concatenate([Ninv[200:230], jnp.zeros(30)]),
    jnp.concatenate([T[200:230], Tg])))

r0, M = t._offset_problem()
n = 300
st = gls.stream_state_init(
    jnp.asarray(r0[:200]), jnp.asarray(M[:200]), jnp.ones(200),
    jnp.zeros((200, 0)), jnp.zeros(0), jnp.zeros(3))
st, dx1, _, _ = gls.stream_state_solve(st, 1)
put("offset/x1", st["x"])
r_tail = r0[200:] + (M[200:, 1:] @ np.asarray(st["x"]))
st = gls.stream_state_append(st, jnp.asarray(r_tail), jnp.asarray(M[200:]),
                             jnp.ones(100), jnp.zeros((100, 0)))
st2, dx2, _, chi2 = gls.stream_state_solve(st, 1)
put("offset/x", st2["x"])
put("offset/chi2", chi2)

r, M, Ninv, T, phi = prob(k=6, seed=25)
st = gls.stream_state_init(r, M, Ninv, T, phi, jnp.zeros(4))
bad = dict(st)
bad["sig_L"] = st["sig_L"] * 37.0
put("drift", gls.stream_state_solve(bad, 0, check_rtol=1e-10)[1:])

r, M, Ninv, T, phi = prob(k=6, seed=26)
os.environ["PINT_TPU_SOLVE_IR"] = "force"
st = gls.stream_state_init(r, M, Ninv, T, phi, jnp.zeros(4))
OUT["forced/dtype"] = np.array(str(st["sig_L"].dtype))
put("forced", gls.stream_state_solve(
    st, 0, check_rtol=solve_policy.stream_drift_rtol())[1:])
del os.environ["PINT_TPU_SOLVE_IR"]
OUT["rtol/default"] = np.asarray(solve_policy.stream_drift_rtol())
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    return run_reference(_SCRIPT, d / "stream.npz", timeout=600)


def _np(t):
    return t.detach().cpu().numpy()


# -- chol_update -----------------------------------------------------------
def test_chol_update_matches_fresh_factorization(ref):
    """A rank-5 update of an 8 x 8 factor: within 1e-12 of the largest
    entry of a fresh factorization of A + V V^T, and of the reference's
    update."""
    A = _spd(8, 1)
    V = np.random.default_rng(2).standard_normal((8, 5))
    L2 = _np(chol_update(torch.as_tensor(np.linalg.cholesky(A)),
                         torch.as_tensor(V)))
    want = np.linalg.cholesky(A + V @ V.T)
    assert np.allclose(L2, want, rtol=0, atol=1e-12 * np.max(want))
    assert np.allclose(L2, ref["update"], rtol=0,
                       atol=1e-12 * np.max(want))


def test_chol_update_degenerate_shapes_are_identity():
    """k = 0 and j = 0: the factor comes back as it was."""
    L0 = torch.zeros((0, 0), dtype=torch.float64)
    assert chol_update(L0, torch.zeros((0, 3), dtype=torch.float64)
                       ).shape == (0, 0)
    L = torch.as_tensor(np.linalg.cholesky(_spd(4, 3)))
    out = chol_update(L, torch.zeros((4, 0), dtype=torch.float64))
    assert torch.equal(out, L)


def test_chol_update_zero_columns_exact_identity(ref):
    """Zero update columns (pad rows of zero weight) pass through bit for
    bit (c == 1, s == 0), as in the reference."""
    L = torch.as_tensor(np.linalg.cholesky(_spd(6, 4)))
    out = chol_update(L, torch.zeros((6, 3), dtype=torch.float64))
    assert torch.equal(out, L)
    assert np.array_equal(_np(out), ref["zero_cols"])


def test_chol_update_nonpositive_pivot_poisons_nan(ref):
    """A NaN pivot poisons the updated factor instead of giving a wrong
    one; the same entries are NaN as in the reference's."""
    L = torch.as_tensor(np.linalg.cholesky(np.eye(3) * 1e-6))
    L[0, 0] = float("nan")
    out = _np(chol_update(L, torch.as_tensor([[10.0], [0.0], [0.0]])))
    assert np.isnan(out).any()
    assert np.array_equal(np.isnan(out), np.isnan(ref["pivot"]))


def test_chol_factor_solve_roundtrip(ref):
    """Two triangular solves with a factor: A X = B to 1e-10, and X
    within 1e-12 relative of the reference's."""
    A = _spd(5, 7)
    B = np.random.default_rng(8).standard_normal((5, 2))
    X = _np(chol_factor_solve(torch.as_tensor(np.linalg.cholesky(A)),
                              torch.as_tensor(B)))
    assert np.allclose(A @ X, B, atol=1e-10)
    assert np.allclose(X, ref["factor_solve"], rtol=1e-12, atol=0)


# -- factor_solve_ir --------------------------------------------------------
def test_factor_solve_ir_refines_stale_factor(ref):
    """An f32-grade factor solves the true f64 matrix after two
    refinement sweeps: A X = B within 1e-9 of max |B|, and X within
    1e-12 relative of the reference's."""
    k = 12
    A = _spd(k, 9)
    L = np.linalg.cholesky(A).astype(np.float32).astype(np.float64)
    B = np.random.default_rng(10).standard_normal((k, 3))
    X = _np(factor_solve_ir(torch.as_tensor(L), torch.as_tensor(A),
                            torch.as_tensor(B), refine=2))
    assert np.allclose(A @ X, B, rtol=0, atol=1e-9 * np.abs(B).max())
    assert np.allclose(X, ref["stale"], rtol=1e-12, atol=0)


def test_factor_solve_ir_check_poisons_on_garbage_factor(ref):
    """A garbage factor without refinement fails the check: all NaN, as
    the reference's."""
    k = 6
    A = _spd(k, 11)
    B = np.random.default_rng(12).standard_normal((k, 2))
    garbage = torch.as_tensor(np.tril(np.full((k, k), 1e-12)))
    X = _np(factor_solve_ir(garbage, torch.as_tensor(A), torch.as_tensor(B),
                            refine=0, check_rtol=1e-8))
    assert np.isnan(X).all() and np.isnan(ref["garbage"]).all()


def test_factor_solve_ir_empty_factor_passthrough():
    B = torch.ones((0, 3), dtype=torch.float64)
    out = factor_solve_ir(torch.zeros((0, 0), dtype=torch.float64),
                          torch.zeros((0, 0), dtype=torch.float64), B)
    assert out.shape == (0, 3)


# -- the stream state against the one-shot solver --------------------------
def _unnorm(covn, norm):
    return _np(covn) / np.outer(_np(norm), _np(norm))


@pytest.mark.parametrize("k", [0, 6])
def test_stream_init_solve_matches_woodbury(ref, k):
    """init + solve against the f64 Woodbury step on the same inputs (dx
    1e-10 relative, the unnormalized covariance 1e-9, chi2 1e-10), the
    advanced state solving to ~0, and dx, covariance and chi2 against
    the reference's stream solve at the same tolerances."""
    r, M, Ninv, T, phi = _problem(k=k, seed=20)
    n, p = M.shape
    st = gls.stream_state_init(r, M, Ninv, T, phi,
                               torch.zeros(p, dtype=torch.float64))
    st2, dx, (covn, norm), chi2 = gls.stream_state_solve(st, 0)
    Tref = T if k else torch.zeros((n, 1), dtype=torch.float64)
    phiref = phi if k else torch.full((1,), 1e-30, dtype=torch.float64)
    ref_dx, (ref_covn, ref_norm), ref_chi2, _ = gls.gls_step_woodbury(
        r, M, 1.0 / Ninv, Tref, phiref, normalized_cov=True)
    assert np.allclose(_np(dx), _np(ref_dx), rtol=1e-10, atol=1e-14)
    cov = _unnorm(covn, norm)
    assert np.allclose(cov, _unnorm(ref_covn, ref_norm), rtol=1e-9)
    assert np.isclose(float(chi2), float(ref_chi2), rtol=1e-10)
    _, dx2, _, _ = gls.stream_state_solve(st2, 0)
    assert np.abs(_np(dx2)).max() < 1e-6 * max(np.abs(_np(dx)).max(), 1e-30)
    key = f"init/{k}"
    assert np.allclose(_np(dx), ref[key + "/0"], rtol=1e-10, atol=1e-14)
    assert np.allclose(cov, ref[key + "/1/0"] / np.outer(
        ref[key + "/1/1"], ref[key + "/1/1"]), rtol=1e-9)
    assert np.isclose(float(chi2), float(ref[key + "/2"]), rtol=1e-10)
    assert np.abs(ref[key + "/again"]).max() < 1e-6 * np.abs(_np(dx)).max()


def test_stream_append_matches_full_init(ref):
    """init(base) + append(tail) in two chunks equals init(base + tail):
    stt within 1e-9 of its largest entry, dx 1e-8 relative, chi2 1e-9,
    the uncertainties 1e-8; and the appended state's blocks and solve
    against the reference's (1e-9 of each block's largest entry, the
    solve at the same tolerances)."""
    r, M, Ninv, T, phi = _problem(n=300, k=6, seed=21)
    nb = 240
    z = torch.zeros(4, dtype=torch.float64)
    st_full = gls.stream_state_init(r, M, Ninv, T, phi, z)
    st = gls.stream_state_init(r[:nb], M[:nb], Ninv[:nb], T[:nb], phi, z)
    for lo, hi in ((nb, 270), (270, 300)):
        st = gls.stream_state_append(st, r[lo:hi], M[lo:hi], Ninv[lo:hi],
                                     T[lo:hi])
    want = _np(st_full["stt"])
    assert np.allclose(_np(st["stt"]), want, rtol=0,
                       atol=1e-9 * max(np.abs(want).max(), 1.0))
    _, dx_a, (cov_a, nrm_a), chi2_a = gls.stream_state_solve(st, 0)
    _, dx_f, (cov_f, nrm_f), chi2_f = gls.stream_state_solve(st_full, 0)
    assert np.allclose(_np(dx_a), _np(dx_f), rtol=1e-8, atol=1e-14)
    assert np.isclose(float(chi2_a), float(chi2_f), rtol=1e-9)
    unc_a = np.sqrt(np.diagonal(_np(cov_a))) / _np(nrm_a)
    unc_f = np.sqrt(np.diagonal(_np(cov_f))) / _np(nrm_f)
    assert np.allclose(unc_a, unc_f, rtol=1e-8)
    for key in ("G", "twx", "stt", "sig_L", "norm"):
        w = ref[f"append/state/{key}"]
        assert np.allclose(_np(st[key]), w, rtol=0,
                           atol=1e-9 * np.abs(w).max()), key
    assert np.allclose(_np(dx_a), ref["append/solve/0"], rtol=1e-8,
                       atol=1e-14)
    assert np.isclose(float(chi2_a), float(ref["append/solve/2"]),
                      rtol=1e-9)


def test_stream_append_pad_rows_exactly_neutral(ref):
    """30 garbage rows at zero weight beside 30 live rows: every block
    within 1e-14 of the live-only append's largest entry (only the two
    products' shapes differ), and the padded append against the
    reference's padded append at 1e-12."""
    r, M, Ninv, T, phi = _problem(n=260, k=6, seed=22)
    st = gls.stream_state_init(r[:200], M[:200], Ninv[:200], T[:200], phi,
                               torch.zeros(4, dtype=torch.float64))
    live = gls.stream_state_append(st, r[200:230], M[200:230],
                                   Ninv[200:230], T[200:230])
    rg, Mg, Tg = (torch.as_tensor(a) for a in _pad_tail())
    padded = gls.stream_state_append(
        st, torch.cat([r[200:230], rg]), torch.cat([M[200:230], Mg]),
        torch.cat([Ninv[200:230], torch.zeros(30, dtype=torch.float64)]),
        torch.cat([T[200:230], Tg]))
    for key in ("G", "twx", "stt", "sig_L"):
        a, b = _np(live[key]), _np(padded[key])
        scale = max(np.abs(a).max(), 1e-30)
        assert np.allclose(a, b, rtol=0, atol=1e-14 * scale), key
        w = ref[f"pad/padded/{key}"]
        assert np.allclose(b, w, rtol=0, atol=1e-12 * scale), key


def test_stream_solve_offset_profiled_not_committed(ref):
    """noffset = 1: the solve commits only the non-offset components and
    re-profiles the offset each solve, so rows appended at the model's
    own phase convention stay consistent: after an append the stream's
    x equals the one-shot full-data step's free part (1e-6 relative,
    1e-9 absolute), as the reference's does."""
    r0, M = _offset_problem()
    n, p = M.shape
    t = torch.as_tensor
    st = gls.stream_state_init(
        t(r0[:200]), t(M[:200]), torch.ones(200, dtype=torch.float64),
        torch.zeros((200, 0), dtype=torch.float64),
        torch.zeros(0, dtype=torch.float64),
        torch.zeros(p - 1, dtype=torch.float64))
    st, dx1, _, _ = gls.stream_state_solve(st, 1)
    assert np.allclose(_np(st["x"]), _np(dx1)[1:], rtol=0,
                       atol=1e-12 * max(np.abs(_np(dx1)).max(), 1.0))
    assert np.allclose(_np(st["x"]), ref["offset/x1"], rtol=1e-10,
                       atol=1e-14)
    r_tail = r0[200:] + (M[200:, 1:] @ _np(st["x"]))
    st = gls.stream_state_append(
        st, t(r_tail), t(M[200:]), torch.ones(n - 200, dtype=torch.float64),
        torch.zeros((n - 200, 0), dtype=torch.float64))
    st2, _, _, chi2 = gls.stream_state_solve(st, 1)
    ref_dx, _, _, _ = gls.gls_step_woodbury(
        t(r0), t(M), torch.ones(n, dtype=torch.float64),
        torch.zeros((n, 1), dtype=torch.float64),
        torch.full((1,), 1e-30, dtype=torch.float64))
    x_stream = _np(st2["x"])
    assert np.allclose(x_stream, _np(ref_dx)[1:], rtol=1e-6, atol=1e-9)
    assert np.isfinite(float(chi2))
    assert np.allclose(x_stream, ref["offset/x"], rtol=1e-6, atol=1e-9)
    assert np.isclose(float(chi2), float(ref["offset/chi2"]), rtol=1e-8)


def test_stream_solve_drift_check_poisons_and_rolls_back(ref):
    """A corrupted maintained factor fails the drift check: dx and chi2
    NaN (as the reference's) and the returned state the unchanged input
    state, tensor for tensor."""
    r, M, Ninv, T, phi = _problem(k=6, seed=25)
    st = gls.stream_state_init(r, M, Ninv, T, phi,
                               torch.zeros(4, dtype=torch.float64))
    bad = dict(st)
    bad["sig_L"] = st["sig_L"] * 37.0
    out, dx, _, chi2 = gls.stream_state_solve(bad, 0, check_rtol=1e-10)
    assert torch.isnan(dx).all() and np.isnan(float(chi2))
    assert np.isnan(ref["drift/0"]).all() and np.isnan(ref["drift/2"])
    for key, v in out.items():
        assert torch.equal(v, bad[key]), key


def test_stream_solve_ir_forced_matches_exact(ref, monkeypatch):
    """PINT_TPU_TORCH_SOLVE_IR=force: the f32 factor and its refinement on
    the CPU, as on the card, agree with the exact f64 path (dx 1e-8
    relative, chi2 1e-8) and with the reference's forced path."""
    r, M, Ninv, T, phi = _problem(k=6, seed=26)
    z = torch.zeros(4, dtype=torch.float64)
    st_exact = gls.stream_state_init(r, M, Ninv, T, phi, z)
    assert st_exact["sig_L"].dtype == torch.float64
    _, dx_e, _, chi2_e = gls.stream_state_solve(st_exact, 0)
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    assert solve_policy.stream_factor_dtype("cpu") == torch.float32
    st = gls.stream_state_init(r, M, Ninv, T, phi, z)
    assert st["sig_L"].dtype == torch.float32
    assert str(ref["forced/dtype"]) == "float32"
    _, dx, _, chi2 = gls.stream_state_solve(
        st, 0, check_rtol=solve_policy.stream_drift_rtol())
    assert np.allclose(_np(dx), _np(dx_e), rtol=1e-8, atol=1e-12)
    assert np.isclose(float(chi2), float(chi2_e), rtol=1e-8)
    assert np.allclose(_np(dx), ref["forced/0"], rtol=1e-8, atol=1e-12)
    assert np.isclose(float(chi2), float(ref["forced/2"]), rtol=1e-8)


def test_stream_drift_rtol_env(ref, monkeypatch):
    """The drift tolerance: the reference's default, and the port's own
    knob PINT_TPU_TORCH_STREAM_DRIFT_RTOL."""
    monkeypatch.delenv("PINT_TPU_TORCH_STREAM_DRIFT_RTOL", raising=False)
    assert solve_policy.stream_drift_rtol() == pytest.approx(
        float(ref["rtol/default"]))
    assert solve_policy.stream_drift_rtol() == pytest.approx(1e-5)
    monkeypatch.setenv("PINT_TPU_TORCH_STREAM_DRIFT_RTOL", "3e-7")
    assert solve_policy.stream_drift_rtol() == pytest.approx(3e-7)


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_stream_append_solve_card_matches_cpu():
    """A 2048-row stream (k = 60, p = 8: init on 1984 rows, two appends
    of 32, a solve) on the card, its f32 maintained factor refined,
    against the same on the CPU in f64: dx and chi2 within 1e-8
    relative; the card's G, twx and stt within 1e-10 of their largest
    entry of a fresh init on all rows (taken to the stream's frozen
    column norms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    r, M, Ninv, T, phi = _problem(n=2048, p=8, k=60, seed=31)
    out = {}
    for dev in ("cpu", "cuda"):
        a = [v.to(dev) for v in (r, M, Ninv, T, phi)]
        z = torch.zeros(8, dtype=torch.float64, device=dev)
        st = gls.stream_state_init(*(v[:1984] for v in a[:4]), a[4], z)
        for lo in (1984, 2016):
            st = gls.stream_state_append(st, *(v[lo:lo + 32]
                                               for v in a[:4]))
        _, dx, _, chi2 = gls.stream_state_solve(
            st, 0, check_rtol=solve_policy.stream_drift_rtol())
        out[dev] = (st, dx.cpu(), float(chi2), gls.stream_state_init(*a, z))
    st, _, _, fresh = out["cuda"]
    assert st["sig_L"].dtype == torch.float32
    gaps = gls.stream_state_gaps(st, fresh)
    assert max(gaps.values()) <= 1e-10, gaps
    dx_g, dx_c = out["cuda"][1], out["cpu"][1]
    assert float((dx_g - dx_c).abs().max() / dx_c.abs().max()) <= 1e-8
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-8)
