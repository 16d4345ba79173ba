"""Generalized-least-squares fit step and fitter (correlated noise).

Counterpart of ``pint_tpu/fitting/gls.py``.  The noise covariance is
C = N + T phi T^T with diagonal N (scaled white errors) and a
reduced-rank basis T (n, k), k << n, solved through the Woodbury identity

  C^-1 = N^-1 - N^-1 T (phi^-1 + T^T N^-1 T)^-1 T^T N^-1

so only k x k and p x p systems are factored.  Two step flavours:

- ``gls_step_woodbury``: exact f64 throughout (the CPU policy, and the
  parity anchor);
- ``gls_step_woodbury_mixed``: the joint Gram of [T | Mn | r] from f32
  values through ``_joint_gram`` (on the card, the hand-written CUDA
  kernel ``ops/fused_gram.py``), then the equilibrated f32 Cholesky +
  f64 refinement tail.  Against the f64 step:
  step directions < 2e-3 of the largest component, chi2 < 1e-3 relative,
  uncertainties < 5e-3.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.fitting.base import (
    Fitter,
    design_with_offset,
    noffset,
    run_fit_loop,
)
from pint_tpu_torch.ops import solve_policy
from pint_tpu_torch.ops.ffgram import nan_cholesky

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
    zeroed.  Returns (x, pinv(A), n_zeroed)."""
    w, V = torch.linalg.eigh(A)
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
    corr = chol_solve_ir(
        Sigma, twx,
        cholesky=solve_policy.ir_cholesky(Sigma.shape[0], dev),
        check_rtol=solve_policy.check_rtol(dev),
    )
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


def default_accel_mode(cm) -> str:
    """The precision policy: mixed on the card when a correlated basis
    exists, exact f64 on the CPU and for pure-white models."""
    if cm.device.type == "cpu":
        return "f64"
    return "mixed" if cm.has_correlated_errors else "f64"


def gauss_newton_step(cm, x, mode: str):
    """One reduced-rank GLS Gauss-Newton step at x:
    -> (x_new, (covn, norm), chi2, nbad), covariance kept normalized."""
    if mode not in ("mixed", "f64"):
        raise ValueError(
            f"unknown GLS step mode {mode!r}: expected 'mixed' or 'f64'"
        )
    step = gls_step_woodbury_mixed if mode == "mixed" else gls_step_woodbury
    no = noffset(cm)
    r = cm.time_residuals(x, subtract_mean=False)
    M = design_with_offset(cm, x)
    Ndiag = torch.square(cm.scaled_sigma(x))
    T, phi = cm.noise_basis_or_empty(x)
    dx, cov, chi2, nbad = step(r, M, Ndiag, T, phi, normalized_cov=True)
    return x + dx[no:], cov, chi2, nbad


class GLSFitter(Fitter):
    """Iterated GLS fit (equals WLS with no correlated noise).

    ``fused='auto'`` takes the mixed step on the card for correlated-noise
    models and the f64 step on the CPU; ``fused=False`` forces f64,
    ``fused='mixed'`` forces mixed.  The opt-in streaming-basis route of
    the reference (``fused=True``) is not ported (ROADMAP B2).  A
    non-finite chi2 raises ConvergenceFailure: the reference's fallback
    ladder is ROADMAP A5."""

    def __init__(self, model, toas, device=None, fused="auto"):
        if fused is True:
            raise NotImplementedError(
                "GLSFitter(fused=True) needs the fourier_gram kernel, "
                "ROADMAP B2"
            )
        if fused not in ("auto", "mixed", False):
            raise ValueError(f"unknown fused={fused!r}")
        super().__init__(model, toas, device=device)
        self.fused = fused

    def _step_mode(self) -> str:
        if self.fused is False:
            return "f64"
        if self.fused == "mixed":
            return "mixed"
        return default_accel_mode(self.cm)

    def fit_toas(self, maxiter: int = 4, tol_chi2: float | None = None):
        mode = self._step_mode()
        if tol_chi2 is None:
            # the mixed step carries ~1e-6 relative f32 noise in chi2
            tol_chi2 = 1e-10 if mode == "f64" else 3e-6
        p = len(self.cm.free_names) + self._noffset
        self.steps_taken = 0

        def live_step(x):
            self.steps_taken += 1
            return gauss_newton_step(self.cm, x, mode)

        result = run_fit_loop(live_step, self.cm.x0(), p, maxiter, tol_chi2)
        self.mode = mode
        return self._finish_fit(
            result,
            "degenerate normal-equation directions zeroed in GLS solve",
            "non-finite chi2 during GLS fit",
        )
