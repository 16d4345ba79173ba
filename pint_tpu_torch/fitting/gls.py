"""Generalized-least-squares fit step and fitter (correlated noise).

Counterpart of ``pint_tpu/fitting/gls.py``.  The noise covariance is
C = N + T phi T^T with diagonal N (scaled white errors) and a
reduced-rank basis T (n, k), k << n, solved through the Woodbury identity

  C^-1 = N^-1 - N^-1 T (phi^-1 + T^T N^-1 T)^-1 T^T N^-1

so only k x k and p x p systems are factored.  Three step flavours:

- ``gls_step_woodbury``: exact f64 throughout (the CPU policy, and the
  parity anchor);
- ``gls_step_woodbury_mixed``: the joint Gram of [T | Mn | r] from f32
  values through ``_joint_gram`` (on the card, the hand-written CUDA
  kernel ``ops/fused_gram.py``), then the equilibrated f32 Cholesky +
  f64 refinement tail.  Against the f64 step:
  step directions < 2e-3 of the largest component, chi2 < 1e-3 relative,
  uncertainties < 5e-3;
- ``gls_step_woodbury_fourier``: the opt-in streaming-basis step
  (``GLSFitter(fused=True)``): the basis Grams from sin/cos generated in
  f32 inside the hand-written CUDA kernel ``ops/fourier.py::fourier_gram``,
  then the same tail.

``gls_step_full_cov`` is the reference's dense-covariance step
(``full_cov=True``): an n x n factorization, f64 on the CPU and mixed
(f32 factor, f64 refinement with the true operator) on the card.  The
streaming state (``stream_state_init``/``_append``/``_solve``) keeps the
normal equations as additive Gram blocks, so appending j TOAs costs
O(j k^2 + k^2 p + p^3), whatever the TOAs already absorbed.

``GLSFitter.fit_toas`` runs every mode down the fallback ladder of
``runtime/fallback.py``: the native mode, then all-f64 on the same
device.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.fitting.base import (
    Fitter,
    design_with_offset,
    noffset,
    run_fit_loop,
)
from pint_tpu_torch.ops import solve_policy
from pint_tpu_torch.ops.ffgram import nan_cholesky
from pint_tpu_torch.runtime.fallback import run_fit_ladder
from pint_tpu_torch.runtime.graphs import host_call

F32 = torch.float32
F64 = torch.float64


def _chol_solve(A, B):
    """Solve A X = B with A symmetric positive-definite via Cholesky; a
    failed factorization yields NaN, as the reference's does."""
    L = nan_cholesky(A)
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, Y, upper=True)


def _column_norms(M):
    """Column norms with |max| pre-scaling, so no squared intermediate
    overflows for the ~1e17-scale F1 column."""
    mx = torch.max(torch.abs(M), dim=0).values
    mx = torch.where(mx == 0, torch.ones_like(mx), mx)
    norm = torch.sqrt(torch.sum(torch.square(M / mx[None, :]), dim=0)) * mx
    return torch.where(norm == 0, torch.ones_like(norm), norm)


def _eigh_threshold_solve(A, b, threshold=None):
    """Min-norm solve of SPD A x = b with near-degenerate eigendirections
    zeroed.  Returns (x, pinv(A), n_zeroed).  ``torch.linalg.eigh`` checks
    its ``info`` on the host, so in a step program it is a split point
    (``runtime/graphs.py::host_call``)."""
    w, V = host_call(torch.linalg.eigh, A)
    if threshold is None:
        threshold = torch.finfo(F64).eps * A.shape[0]
    bad = w < threshold * torch.max(w)
    winv = torch.where(bad, torch.zeros_like(w),
                       1.0 / torch.where(bad, torch.ones_like(w), w))
    Vw = V * winv[None, :]
    return Vw @ (V.T @ b), Vw @ V.T, torch.sum(bad)


def _finish_normal_eqs(A, b, r_cinv_r, norm, normalized_cov=False,
                       ir=False):
    """Shared normal-equation tail: solve, covariance, chi2 = r^T C^-1 r
    minus the fitted decrement dx^T b, column un-normalization.  ``ir``
    opts the p x p solve into the refined-solve policy (the mixed paths);
    the f64 paths keep the eigh solve and its degeneracy semantics."""
    dev = A.device
    if ir and solve_policy.ir_active(dev):
        from pint_tpu_torch.ops.ffgram import chol_solve_ir

        p = A.shape[0]
        X = chol_solve_ir(
            A, torch.cat([b[:, None], torch.eye(p, dtype=F64, device=dev)],
                         dim=1),
            cholesky=solve_policy.ir_cholesky(p, dev),
            check_rtol=solve_policy.check_rtol(dev),
        )
        dxn = X[:, 0]
        covn = 0.5 * (X[:, 1:] + X[:, 1:].T)
        nbad = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        dxn, covn, nbad = _eigh_threshold_solve(A, b)
    chi2 = r_cinv_r - torch.dot(dxn, b)
    if normalized_cov:
        return dxn / norm, (covn, norm), chi2, nbad
    return dxn / norm, covn / torch.outer(norm, norm), chi2, nbad


def _solve_normal_eqs(cinv_mult, r, M, normalized_cov=False):
    norm = _column_norms(M)
    Mn = M / norm[None, :]
    CiM = cinv_mult(Mn)
    Cir = cinv_mult(r[:, None])[:, 0]
    A = Mn.T @ CiM
    b = -(Mn.T @ Cir)
    return _finish_normal_eqs(A, b, torch.dot(r, Cir), norm, normalized_cov)


def woodbury_sigma(Ndiag, T, phi):
    """(Ninv, TN = N^-1 T, Sigma = phi^-1 + T^T N^-1 T)."""
    Ninv = 1.0 / Ndiag
    TN = T * Ninv[:, None]
    Sigma = torch.diag(1.0 / phi) + T.T @ TN
    return Ninv, TN, Sigma


def make_cinv_mult(Ndiag, T, phi):
    """X -> C^-1 X for C = diag(Ndiag) + T diag(phi) T^T via Woodbury."""
    Ninv, TN, Sigma = woodbury_sigma(Ndiag, T, phi)

    def cinv_mult(X):
        return X * Ninv[:, None] - TN @ _chol_solve(Sigma, TN.T @ X)

    return cinv_mult


def gls_step_woodbury(r, M, Ndiag, T, phi, normalized_cov=False):
    """One exact-f64 GLS normal-equation solve, reduced-rank path:
    (dx (p,), cov, chi2, n_degenerate)."""
    return _solve_normal_eqs(make_cinv_mult(Ndiag, T, phi), r, M,
                             normalized_cov)


def _woodbury_mixed_tail(G_XX, sig_tt, twx, phi, norm,
                         normalized_cov=False):
    """Mixed-precision Woodbury assembly from the f32-grade Grams
    G_XX = X^T N^-1 X (X = [Mn | r]), sig_tt = T^T N^-1 T and
    twx = T^T N^-1 X; the k x k solve is the equilibrated f32 Cholesky +
    f64 refinement of ops/ffgram.py::chol_solve_ir."""
    from pint_tpu_torch.ops.ffgram import chol_solve_ir

    dev = G_XX.device
    A_white = G_XX[:-1, :-1]
    b_white = G_XX[:-1, -1]
    r_Nr = G_XX[-1, -1]
    Sigma = torch.diag(1.0 / phi) + sig_tt
    corr = chol_solve_ir(Sigma, twx,
                         cholesky=solve_policy.ir_cholesky(Sigma.shape[0],
                                                           dev),
                         check_rtol=solve_policy.check_rtol(dev))
    A = A_white - twx[:, :-1].T @ corr[:, :-1]
    b = -(b_white - twx[:, :-1].T @ corr[:, -1])
    r_cinv_r = r_Nr - torch.dot(twx[:, -1], corr[:, -1])
    return _finish_normal_eqs(A, b, r_cinv_r, norm, normalized_cov, ir=True)


def _joint_gram(T, X, Ninv):
    """The fused-or-unfused joint Gram of the mixed Woodbury interior —
    the one chokepoint the policy gates: the fused kernel when the policy
    is active and the shape is inside its block table, the chunked
    gram32_joint otherwise."""
    from pint_tpu_torch.ops.ffgram import gram32_joint

    n, p1 = X.shape
    k = T.shape[-1]
    if solve_policy.fused_interior_active(X.device):
        from pint_tpu_torch.ops.fused_gram import (
            fused_block_table,
            fused_gram_joint,
        )

        if fused_block_table(n, k, p1) is not None:
            # T goes in as f64: the kernel rounds it to f32 in registers,
            # the same values as a cast here, without the cast pass
            return fused_gram_joint(T, X, Ninv)
    return gram32_joint(T.to(F32), X, Ninv)


def gls_step_woodbury_mixed(r, M, Ndiag, T, phi, normalized_cov=False):
    """Woodbury GLS with the noise side from f32 values: the joint Gram
    of [T | Mn | r] in one pass, then the mixed tail."""
    Ninv = 1.0 / Ndiag
    norm = _column_norms(M)
    Mn = M / norm[None, :]
    X = torch.cat([Mn, r[:, None]], dim=1)
    sig_tt, twx, G_XX = _joint_gram(T, X, Ninv)
    return _woodbury_mixed_tail(G_XX, sig_tt, twx, phi, norm,
                                normalized_cov)


def _white_gram(X, Ninv):
    """G_XX = X^T N^-1 X of the streaming-basis step: ``gram32``'s f32
    values f32(X sqrt(N^-1)), their products summed in f64 (one f64
    product), where the reference's ``gram32`` sums 128-row chunks in
    f32.  On the bench pulsar those f32 sums move the step's dx by
    1.6e-5 at 2048 TOAs and 6.5e-5 at 16384 when only their order
    changes, and put it 1.2 sigma off the exact step at 16384
    (profiling/torch_fourier_precision.py, PERF.md): with them the
    card's step could be held neither to the CPU's nor near the exact
    step.  f64 sums are the fused kernels' choice too (ops/fused_gram.py,
    ops/fourier.py)."""
    Y = (X * torch.sqrt(Ninv)[:, None]).to(F32).to(F64)
    return Y.T @ Y


def gls_step_woodbury_fourier(r, M, Ndiag, t_sec, freqs, phi,
                              normalized_cov=False):
    """Woodbury GLS with the streaming-basis Grams: Sigma = T^T N^-1 T and
    T^T N^-1 [Mn | r] for the pure-Fourier basis T = [sin | cos](2 pi f t)
    from ``ops/fourier.py::fourier_gram`` (on the card, the hand-written
    CUDA kernel; T is never materialized), G_XX from ``_white_gram``,
    then the shared mixed tail.  Requires a pure-Fourier basis
    (CompiledModel.noise_fourier_spec).

    Accuracy: the basis values are the reference's f32 ones, whose phase
    arguments carry ~1e-5 rad at multi-year spans — a systematic basis
    perturbation that moves the step ~0.1 sigma off the exact step at
    1e5 TOAs on the bench pulsar (PERF.md).  The reference makes the
    route opt-in for that reason, and so does the port."""
    from pint_tpu_torch.ops.fourier import fourier_gram

    Ninv = 1.0 / Ndiag
    norm = _column_norms(M)
    Mn = M / norm[None, :]
    X = torch.cat([Mn, r[:, None]], dim=1)
    # the kernel's sums are f64 already: no cast, unlike the reference
    sig_tt, twx = fourier_gram(t_sec, freqs, Ninv, X)
    return _woodbury_mixed_tail(_white_gram(X, Ninv), sig_tt, twx, phi,
                                norm, normalized_cov)


def full_cov_method(device, method=None) -> str:
    """The dense step's method: ``method`` if given, else mixed on the
    card and f64 on the CPU."""
    if method is None:
        method = "mixed" if torch.device(device).type == "cuda" else "f64"
    if method not in ("mixed", "f64"):
        raise ValueError(f"unknown full_cov method {method!r}: expected "
                         "'mixed' or 'f64'")
    return method


def gls_step_full_cov(r, M, Ndiag, T, phi, method=None,
                      normalized_cov=False):
    """Dense-covariance GLS step: C = diag(Ndiag) + T diag(phi) T^T
    factored as an n x n matrix (the reference's ``full_cov=True``).

    ``method`` (None: mixed on the card, f64 on the CPU):
    - 'mixed' with a basis: ``ops/ffgram.py::woodbury_chol_solve_ir``
      (the equilibrated f32 covariance and its f32 factor, refined with
      the true operator in f64; C is never formed in f64), the factor
      the solve policy names for n (``ir_cholesky``), then X^T C^-1 X by
      ``matmul_split32`` and the refined normal-equation tail;
    - 'mixed' pure white (``T`` None): ``chol_solve_ir`` on the dense C;
    - 'f64': ``nan_cholesky`` of the dense C and two triangular
      solves (the upper one against the factor's transposed view, no
      copy), then the eigh normal-equation tail.
    Same tolerance class as the reduced-rank mixed step."""
    from pint_tpu_torch.models.noise import dense_noise_cov
    from pint_tpu_torch.ops.ffgram import (
        chol_solve_ir,
        matmul_split32,
        woodbury_chol_solve_ir,
    )

    dev = r.device
    method = full_cov_method(dev, method)
    if method == "mixed":
        norm = _column_norms(M)
        Mn = M / norm[None, :]
        X = torch.cat([Mn, r[:, None]], dim=1)
        n = X.shape[0]
        policy = dict(cholesky=solve_policy.ir_cholesky(n, dev),
                      check_rtol=solve_policy.check_rtol(dev))
        if T is not None:
            CiX = woodbury_chol_solve_ir(Ndiag, T, phi, X, **policy)
        else:
            CiX = chol_solve_ir(dense_noise_cov(Ndiag, None, None), X,
                                **policy)
        G = matmul_split32(X.T, CiX)
        return _finish_normal_eqs(G[:-1, :-1], -G[:-1, -1], G[-1, -1],
                                  norm, normalized_cov, ir=True)
    L = nan_cholesky(dense_noise_cov(Ndiag, T, phi))

    def cinv_mult(X):
        Y = torch.linalg.solve_triangular(L, X, upper=False)
        return torch.linalg.solve_triangular(L.mT, Y, upper=True)

    return _solve_normal_eqs(cinv_mult, r, M, normalized_cov)


# -- the O(append) streaming state -------------------------------------------
#
# A timing stream keeps the GLS normal equations as additive Gram blocks,
# so appending j TOAs costs O(j k^2 + k^2 p + p^3), independent of the n
# TOAs already absorbed (the reference's ``fitting/gls.py:451-611``):
#
#   G     (q, q)  X^T N^-1 X for X = [Mn | r], q = p1 + 1
#   twx   (k, q)  T^T N^-1 X
#   stt   (k, k)  T^T N^-1 T          (Sigma = diag(1/phi) + stt)
#   sig_L (k, k)  the maintained Cholesky factor of the equilibrated Sigma
#                 (frozen Jacobi diagonal sig_d), advanced a rank-j update
#                 an append (ops/cholupdate.py::chol_update), in
#                 solve_policy.stream_factor_dtype
#   norm  (p1,)   frozen column norms: normalization must not move between
#                 appends, or the blocks stop being additive
#   x     (nfree,) the current solution; the r-dependent blocks refer to
#                 residuals at this x
#
# Appended rows enter with their exact weight and pad rows with exactly
# zero weight.  A solve advances the r-dependent blocks by the
# linearization r(x + dx) = r(x) + Mn dxn, with the offset components of
# dx zeroed first, and both of its solves carry the drift check.


def stream_state_init(r, M, Ninv, T, phi, x):
    """The streaming Gram state of full arrays at solution x: the only
    O(n) solver work of a stream.  ``Ninv`` is the per-row inverse white
    variance, exactly 0 on pad rows.  -> the state dict above, plus
    ``phi_inv`` and ``sig_d``."""
    dev = r.device
    fdt = solve_policy.stream_factor_dtype(dev)
    norm = _column_norms(M * torch.sqrt(Ninv)[:, None])
    Mn = M / norm[None, :]
    X = torch.cat([Mn, r[:, None]], dim=1)
    XN = X * Ninv[:, None]
    G = X.T @ XN
    twx = T.T @ XN
    stt = (T * Ninv[:, None]).T @ T
    phi_inv = 1.0 / phi
    k = T.shape[1]
    if k:
        Sigma = torch.diag(phi_inv) + stt
        sig_d = torch.diagonal(Sigma).clone()
        dinv = 1.0 / torch.sqrt(sig_d)
        sig_L = nan_cholesky((Sigma * torch.outer(dinv, dinv)).to(fdt))
    else:
        sig_d = torch.ones((0,), dtype=F64, device=dev)
        sig_L = torch.zeros((0, 0), dtype=fdt, device=dev)
    return {"G": G, "twx": twx, "stt": stt, "sig_L": sig_L, "sig_d": sig_d,
            "phi_inv": phi_inv, "norm": norm,
            "x": torch.as_tensor(x, dtype=F64, device=dev)}


def stream_state_append(state, r_j, M_j, Ninv_j, T_j):
    """Absorb j appended rows: the additive Gram updates and the rank-j
    update of the maintained equilibrated Sigma factor.  ``Ninv_j`` must
    carry exact zeros on pad rows.  -> a new state; the input is left as
    it was."""
    from pint_tpu_torch.ops.cholupdate import chol_update

    Mn_j = M_j / state["norm"][None, :]
    X_j = torch.cat([Mn_j, r_j[:, None]], dim=1)
    XN_j = X_j * Ninv_j[:, None]
    out = dict(state)
    out["G"] = state["G"] + X_j.T @ XN_j
    out["twx"] = state["twx"] + T_j.T @ XN_j
    out["stt"] = state["stt"] + (T_j * Ninv_j[:, None]).T @ T_j
    if state["sig_L"].shape[0]:
        V = T_j.T * torch.sqrt(Ninv_j)[None, :]
        Veq = V / torch.sqrt(state["sig_d"])[:, None]
        out["sig_L"] = chol_update(state["sig_L"], Veq)
    return out


def stream_state_solve(state, noffset_: int, check_rtol=None):
    """One exact GLS solve of the state (a linear least-squares problem,
    so one solve is its converged answer) and the linearized advance of
    the r-dependent blocks to the new x.

    -> (state', dx (p1,), (covn, norm), chi2), the covariance normalized
    as ``_finish_normal_eqs`` leaves it.  The maintained-factor Sigma
    solve and the p x p solve both carry the ``check_rtol`` drift check
    (None: no check); where it fails, dx and chi2 are NaN and state' is
    the unchanged input state, chosen by ``torch.where`` on the device."""
    from pint_tpu_torch.ops.cholupdate import factor_solve_ir
    from pint_tpu_torch.ops.ffgram import chol_solve_ir

    G, twx = state["G"], state["twx"]
    dev = G.device
    k = twx.shape[0]
    if k:
        dinv = 1.0 / torch.sqrt(state["sig_d"])
        Sigma_eq = ((torch.diag(state["phi_inv"]) + state["stt"])
                    * torch.outer(dinv, dinv))
        corr = dinv[:, None] * factor_solve_ir(
            state["sig_L"], Sigma_eq, dinv[:, None] * twx,
            check_rtol=check_rtol)
        A = G[:-1, :-1] - twx[:, :-1].T @ corr[:, :-1]
        b = -(G[:-1, -1] - twx[:, :-1].T @ corr[:, -1])
        r_cinv_r = G[-1, -1] - torch.dot(twx[:, -1], corr[:, -1])
    else:
        A = G[:-1, :-1]
        b = -G[:-1, -1]
        r_cinv_r = G[-1, -1]
    p = A.shape[0]
    X = chol_solve_ir(
        A, torch.cat([b[:, None], torch.eye(p, dtype=F64, device=dev)],
                     dim=1),
        check_rtol=check_rtol)
    dxn = X[:, 0]
    covn = 0.5 * (X[:, 1:] + X[:, 1:].T)
    chi2 = r_cinv_r - torch.dot(dxn, b)
    # the linearized advance r -> r + Mn dxa of every r-dependent block,
    # with the offset components zeroed first: the fitter never commits
    # them (step_from returns x + dx[no:]), and appended rows are
    # evaluated at the model's own phase convention, so an offset folded
    # into the stored r column would put old and new rows a constant
    # apart that the next solve's offset column cannot absorb
    dxa = torch.cat([torch.zeros_like(dxn[:noffset_]), dxn[noffset_:]])
    gmr = G[:-1, -1]
    Gd = G[:-1, :-1] @ dxa
    G2 = G.clone()
    G2[:-1, -1] = gmr + Gd
    G2[-1, :-1] = gmr + Gd
    G2[-1, -1] = G[-1, -1] + 2.0 * torch.dot(dxa, gmr) + torch.dot(dxa, Gd)
    out = dict(state)
    out["G"] = G2
    if k:
        twx2 = twx.clone()
        twx2[:, -1] = twx[:, -1] + twx[:, :-1] @ dxa
        out["twx"] = twx2
    out["x"] = state["x"] + (dxn / state["norm"])[noffset_:]
    # a failed check leaves the state as it was
    ok = torch.isfinite(chi2) & torch.all(torch.isfinite(dxn))
    out = {key: torch.where(ok, v, state[key]) for key, v in out.items()}
    return out, dxn / state["norm"], (covn, state["norm"]), chi2


def stream_state_gaps(state, fresh) -> dict:
    """How far a streamed state's additive blocks are from ``fresh``, a
    ``stream_state_init`` of all the rows it absorbed: the largest gap of
    G, twx and stt, each over its largest entry, with fresh's G and twx
    first taken to the stream's frozen column norms (G and twx are
    X^T N^-1 X and T^T N^-1 X of X = [M / norm | r])."""
    s = torch.cat([fresh["norm"] / state["norm"],
                   torch.ones(1, dtype=F64, device=state["norm"].device)])
    want = {"G": fresh["G"] * torch.outer(s, s),
            "twx": fresh["twx"] * s[None, :], "stt": fresh["stt"]}
    return {key: float(torch.max(torch.abs(state[key] - w))
                       / torch.max(torch.abs(w)))
            for key, w in want.items() if w.numel()}


def default_accel_mode(cm) -> str:
    """The precision policy: mixed on the card when a correlated basis
    exists, exact f64 on the CPU and for pure-white models."""
    if cm.device.type == "cpu":
        return "f64"
    return "mixed" if cm.has_correlated_errors else "f64"


def narrowband_inputs(cm, x):
    """(residuals, design with offset, Ndiag) of one narrowband step."""
    r = cm.time_residuals(x, subtract_mean=False)
    M = design_with_offset(cm, x)
    Ndiag = torch.square(cm.scaled_sigma(x))
    return r, M, Ndiag


def step_from(x, mode: str, no: int, inputs, noise, fourier_spec):
    """One reduced-rank GLS Gauss-Newton step at x from its parts:
    ``inputs`` = (r, M, Ndiag), ``noise()`` -> (T, phi) of the same rows,
    ``fourier_spec()`` -> (t_sec, freqs, phi) for the fourier mode;
    -> (x_new, (covn, norm), chi2, nbad), covariance kept normalized."""
    if mode not in ("mixed", "f64", "fourier"):
        raise ValueError(
            f"unknown GLS step mode {mode!r}: expected 'mixed', 'f64' or "
            "'fourier'"
        )
    r, M, Ndiag = inputs
    if mode == "fourier":
        t_sec, freqs, phi = fourier_spec()
        dx, cov, chi2, nbad = gls_step_woodbury_fourier(
            r, M, Ndiag, t_sec, freqs, phi, normalized_cov=True
        )
    else:
        step = (gls_step_woodbury_mixed if mode == "mixed"
                else gls_step_woodbury)
        T, phi = noise()
        dx, cov, chi2, nbad = step(r, M, Ndiag, T, phi, normalized_cov=True)
    return x + dx[no:], cov, chi2, nbad


def gauss_newton_step(cm, x, mode: str):
    """One reduced-rank GLS Gauss-Newton step at x of a narrowband model:
    -> (x_new, (covn, norm), chi2, nbad), covariance kept normalized."""
    return step_from(x, mode, noffset(cm), narrowband_inputs(cm, x),
                     lambda: cm.noise_basis_or_empty(x),
                     lambda: cm.noise_fourier_spec(x))


class GLSFitter(Fitter):
    """Iterated GLS fit (equals WLS with no correlated noise).

    ``fused='auto'`` takes the mixed step on the card for correlated-noise
    models and the f64 step on the CPU; ``fused=False`` forces f64,
    ``fused='mixed'`` forces mixed, and ``fused=True`` opts into the
    streaming-basis step (``gls_step_woodbury_fourier``; its accuracy note
    says why it is opt-in).  ``full_cov=True`` takes the dense-covariance
    step (``gls_step_full_cov``): mixed on the card and f64 on the CPU,
    f64 everywhere with ``fused=False``; with ``fused=True`` or
    ``'mixed'`` it raises the reference's PintTpuError.  ``fit_toas``
    runs the fit down the fallback ladder (``runtime/fallback.py``:
    native mode, then all-f64, on the same device; no CPU rung; the f64
    rung of a ``full_cov`` fit is the reduced-rank Woodbury f64 step, the
    same C through a factorization without the n x n hazards);
    ``self.guard_report`` records which rung served the result and what
    tripped on the way down."""

    def __init__(self, toas, model, full_cov: bool = False, fused="auto", *,
                 device=None):
        if fused not in ("auto", "mixed", False, True):
            raise ValueError(f"unknown fused={fused!r}")
        if full_cov and fused in (True, "mixed"):
            raise PintTpuError(
                f"fused={fused!r} and full_cov=True are mutually "
                "exclusive (the fused/mixed paths are reduced-rank by "
                "construction)"
            )
        super().__init__(toas, model, device=device)
        self.full_cov = full_cov
        self.fused = fused

    # -- the step's parts: the wideband fitter stacks [TOA; DM] rows ------
    def _step_inputs(self, x):
        """(residuals, design with offset, Ndiag) of one GLS step."""
        return narrowband_inputs(self.cm, x)

    def _step_noise(self, x):
        """(T, phi): the reduced-rank basis of _step_inputs' rows."""
        return self.cm.noise_basis_or_empty(x)

    def _fourier_available(self) -> bool:
        """Whether the streaming-basis (fourier) step applies."""
        return self.cm.noise_fourier_spec(self.cm.x0()) is not None

    def _full_cov_method(self) -> str:
        """The dense step's method: f64 with ``fused=False``, else the
        device's (``full_cov_method``)."""
        return full_cov_method(self.device,
                               "f64" if self.fused is False else None)

    def _gn_step(self, x, mode: str):
        """One Gauss-Newton step built from the three hooks."""
        if mode == "full_cov":
            r, M, Ndiag = self._step_inputs(x)
            T, phi = self._step_noise(x)
            dx, cov, chi2, nbad = gls_step_full_cov(
                r, M, Ndiag, T, phi, method=self._full_cov_method(),
                normalized_cov=True)
            return x + dx[self._noffset:], cov, chi2, nbad
        return step_from(x, mode, self._noffset, self._step_inputs(x),
                         lambda: self._step_noise(x),
                         lambda: self.cm.noise_fourier_spec(x))

    def _step_mode(self) -> str:
        """'full_cov' (the dense step), 'fourier' (streaming-basis
        Grams), 'mixed' (general-basis f32 Grams) or 'f64'."""
        if self.full_cov:
            return "full_cov"
        if self.fused is False:
            return "f64"
        if self.fused == "mixed":
            return "mixed"
        if self.fused is True:
            if not self._fourier_available():
                raise PintTpuError(
                    "fused=True needs a single pure-Fourier correlated-"
                    "noise basis (PL red noise)"
                )
            return "fourier"
        return default_accel_mode(self.cm)

    def fit_toas(self, maxiter: int = 4, tol_chi2: float | None = None):
        mode = self._step_mode()
        if tol_chi2 is None:
            # the mixed-precision modes carry ~1e-6 relative f32 noise in
            # chi2 between iterations; the dense step is exact only when
            # its method is f64
            exact = mode == "f64" or (mode == "full_cov"
                                      and self._full_cov_method() == "f64")
            tol_chi2 = 1e-10 if exact else 3e-6
        p = len(self.cm.free_names) + self._noffset

        def run_loop(rung_mode):
            # one step program a rung; steps_taken counts the steps (on
            # the card, its replays) of the rung that serves
            step = self.cm.program(lambda x: self._gn_step(x, rung_mode),
                                   ("gls", rung_mode, p))
            self.steps_taken = 0

            def live_step(x):
                self.steps_taken += 1
                return step(x)

            return run_fit_loop(live_step, self.cm.x0(), p, maxiter,
                                tol_chi2)

        result, self.guard_report = run_fit_ladder(
            self.cm, mode, run_loop,
            site=f"fit:{type(self).__name__}",
            fail_msg="non-finite chi2 during GLS fit",
        )
        self.mode = mode
        return self._finish_fit(
            result,
            "degenerate normal-equation directions zeroed in GLS solve",
        )
