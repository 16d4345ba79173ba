"""Weighted-least-squares step and fitter (uncorrelated errors).

Counterpart of ``pint_tpu/fitting/wls.py``: iterate residuals, design
matrix (plus the implicit offset column), a column-normalized
least-squares solve, step, chi2.  The solve has three methods — the
reference's column-scaled SVD, a Householder QR with a rank gate, and
the thresholded-eigh solve of the normal equations — and the policy of
which runs where is the reference's, per device (``default_wls_method``).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.exceptions import CorrelatedErrors
from pint_tpu_torch.fitting.base import (
    Fitter,
    design_with_offset,
    run_fit_loop,
)
from pint_tpu_torch.fitting.gls import _column_norms, _eigh_threshold_solve
from pint_tpu_torch.runtime.fallback import run_fit_ladder

F64 = torch.float64

#: QR acceptance: min|R_ii| / max|R_ii| above this takes the QR answer;
#: below it (near-exact degeneracy) the thresholded-eigh gram solve zeroes
#: the bad directions and reports them
_QR_DIAG_RTOL = 1e-8

#: Ceiling on the one-solve condition estimate of R: |R_ii| ratios alone
#: under-reveal rank for unpivoted QR (a Kahan-type matrix keeps benign
#: diagonals while R^-1 explodes), so the gate also takes the growth of
#: R^-1 @ 1.  Past ~1e13 the QR answer's relative error (~cond * 1e-13)
#: reaches O(1), and the gram solve, which zeroes the degenerate
#: directions, loses nothing.
_QR_COND_MAX = 1e13


def default_wls_method(device=None) -> str:
    """The WLS solve method on ``device`` (None: the CUDA card): the
    reference's column-scaled ``'svd'`` on the CPU, ``'qr'`` on the card.

    The reference takes QR on its accelerator because the TPU's emulated
    f64 SVD fails there.  The card's f64 is IEEE, so that reason does not
    carry over, but the reference's per-backend choice stands until a
    measurement on the card decides otherwise."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    return "svd" if dev.type == "cpu" else "qr"


def _qr_gate(R):
    """The QR route's rank gate on the factor R of the normalized weighted
    design: -> (rank_ok, diag_ratio, cond_est), 0-d tensors on R's
    device, rank_ok the reference's ``lax.cond`` predicate.  The growth of
    z = R^-1 @ 1 lower-bounds ||R^-1||; with unit-norm columns
    ||R|| <= sqrt(p), so max|z| * max|R_ii| ~ cond(R); a non-finite growth
    (an exactly singular R) fails the gate too."""
    diag = torch.abs(torch.diagonal(R))
    z = torch.linalg.solve_triangular(
        R, torch.ones((R.shape[1], 1), dtype=R.dtype, device=R.device),
        upper=True)
    cond_est = torch.max(torch.abs(z)) * diag.max()
    ok = ((diag.min() > _QR_DIAG_RTOL * diag.max())
          & torch.isfinite(cond_est) & (cond_est < _QR_COND_MAX))
    return ok, diag.min() / diag.max(), cond_est


def _qr_solve(A, b, threshold):
    """The ``'qr'`` solve: the QR answer where the gate passes, else the
    thresholded-eigh gram answer, chosen on the device by ``torch.where``
    (both are computed, so a step program holds no host read).
    -> (dx, covn, nbad, (rank_ok, diag_ratio, cond_est))."""
    Q, R = torch.linalg.qr(A)
    gate = _qr_gate(R)
    p = A.shape[1]
    Rinv = torch.linalg.solve_triangular(
        R, torch.eye(p, dtype=A.dtype, device=A.device), upper=True)
    gdx, gcov, gbad = _eigh_threshold_solve(A.T @ A, A.T @ b, threshold)
    ok = gate[0]
    return (torch.where(ok, Rinv @ (Q.T @ b), gdx),
            torch.where(ok, Rinv @ Rinv.T, gcov),
            torch.where(ok, torch.zeros_like(gbad), gbad), gate)


def _wls_step(r, M, w, threshold=None, method=None, normalized_cov=False,
              with_gate=False):
    """One WLS least-squares solve with degenerate-direction zeroing.

    r (n,), M (n, p) = d resid / d x, w (n,) weights -> (delta_x (p,),
    covariance (p, p), n_degenerate); with ``normalized_cov`` the
    covariance comes back as (covn, norm), the column norms apart;
    ``with_gate`` appends the QR gate's (rank_ok, diag_ratio, cond_est)
    tensors (None when the QR route did not run).
    Columns are scaled to unit weighted norm first, as the reference
    does.

    - ``'svd'``: the reference's column-scaled SVD least squares,
      singular values below ``threshold * s_max`` cut.
    - ``'qr'``: a reduced Householder QR of the normalized weighted
      design, taken unless the factor looks rank-deficient — a diagonal
      ratio below ``_QR_DIAG_RTOL`` or a one-solve condition estimate
      above ``_QR_COND_MAX`` — in which case the ``'gram'`` answer is
      returned (``_qr_solve``: a device predicate, as the reference's
      ``lax.cond``).  Underdetermined shapes (n < p: R is not square) go
      to ``'gram'``.
    - ``'gram'``: the p x p normal equations by thresholded eigh
      (``gls.py::_eigh_threshold_solve``); the Gram squares the
      condition number.
    ``threshold`` defaults to eps * max(n, p)."""
    if method is None:
        method = default_wls_method(r.device)
    sw = torch.sqrt(w)
    b = -r * sw
    norm = _column_norms(M * sw[:, None])
    A = (M / norm[None, :]) * sw[:, None]
    if threshold is None:
        threshold = torch.finfo(F64).eps * max(A.shape)
    if method == "qr" and A.shape[0] < A.shape[1]:
        method = "gram"
    gate = None
    if method == "gram":
        dx, covn, nbad = _eigh_threshold_solve(A.T @ A, A.T @ b, threshold)
    elif method == "qr":
        dx, covn, nbad, gate = _qr_solve(A, b, threshold)
    elif method == "svd":
        U, s, Vt = torch.linalg.svd(A, full_matrices=False)
        bad = s < threshold * s[0]
        s_inv = torch.where(bad, torch.zeros_like(s),
                            1.0 / torch.where(bad, torch.ones_like(s), s))
        dx = (Vt.T * s_inv[None, :]) @ (U.T @ b)
        covn = (Vt.T * torch.square(s_inv)[None, :]) @ Vt
        nbad = torch.sum(bad)
    else:
        raise ValueError(
            f"unknown WLS method {method!r}: expected 'svd', 'qr' or 'gram'")
    cov = (covn, norm) if normalized_cov else covn / torch.outer(norm, norm)
    if with_gate:
        return dx / norm, cov, nbad, gate
    return dx / norm, cov, nbad


class WLSFitter(Fitter):
    """Iterated WLS fit for models without correlated noise.  ``fit_toas``
    runs one rung of the fallback ladder (``f"{device}-{method}"``, e.g.
    ``cuda-qr``): the WLS solve is already the f64 path.  Each step is a
    replay of one step program; ``qr_gate`` reports the last step's QR
    gate (None for another method), read after the fit."""

    qr_gate = None

    def _make_step(self, method: str):
        cm, no = self.cm, self._noffset

        def step(x):
            # residuals without mean subtraction: the offset column
            # absorbs the mean
            r = cm.time_residuals(x, subtract_mean=False)
            M = design_with_offset(cm, x)
            w = 1.0 / torch.square(cm.scaled_sigma(x))
            dx, cov, nbad, gate = _wls_step(r, M, w, method=method,
                                            normalized_cov=True,
                                            with_gate=True)
            x_new = x + dx[no:]  # dx[0] is the offset column's
            return x_new, cov, cm.chi2(x_new), nbad, gate

        return step

    def fit_toas(self, maxiter: int = 4, tol_chi2: float = 1e-10) -> float:
        if self.cm.has_correlated_errors:
            raise CorrelatedErrors(self.model)
        self.wls_method = default_wls_method(self.device)
        p = len(self.cm.free_names) + self._noffset
        gates = []

        def run_loop(_rung_mode):
            step = self.cm.program(self._make_step(self.wls_method),
                                   ("wls", self.wls_method, p))
            self.steps_taken = 0

            def live_step(x):
                self.steps_taken += 1
                *out, gate = step(x)
                gates.append(gate)
                return out

            return run_fit_loop(live_step, self.cm.x0(), p, maxiter,
                                tol_chi2, init_chi2=self.cm.chi2)

        result, self.guard_report = run_fit_ladder(
            self.cm, self.wls_method, run_loop,
            site=f"fit:{type(self).__name__}",
            fail_msg="non-finite chi2 during WLS fit",
            f64_rung=False,
        )
        if gates and gates[-1] is not None:
            ok, ratio, cond = gates[-1]
            self.qr_gate = dict(rank_ok=bool(ok), diag_ratio=float(ratio),
                                cond_est=float(cond))
        return self._finish_fit(
            result,
            "degenerate design-matrix directions zeroed in WLS solve "
            f"(method={self.wls_method})",
        )
