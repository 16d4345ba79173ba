"""Shared fitter machinery.

Counterpart of ``pint_tpu/fitting/base.py``: the implicit offset column
and the Gauss-Newton iteration of ``make_scan_fit_loop``, here a Python
loop on the device with the same step semantics — chi2 is measured
before the step, the loop freezes on a non-finite chi2, and it stops when
chi2 stops moving.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from pint_tpu_torch.device import F64


class DegeneracyWarning(UserWarning):
    """Near-degenerate normal-equation directions were zeroed."""


class ConvergenceFailure(RuntimeError):
    """A fit step produced a non-finite chi2."""


def noffset(cm) -> int:
    """1 when the implicit offset column is in use; 0 when a free PHOFF
    replaces it."""
    return 0 if "PHOFF" in cm.free_names else 1


def design_with_offset(cm, x):
    """Design matrix with the implicit offset column prepended."""
    M = cm.design_matrix(x)
    if not noffset(cm):
        return M
    ones = torch.ones((cm.bundle.ntoa, 1), dtype=F64, device=M.device)
    return torch.cat([ones, M], dim=1)


def run_fit_loop(live_step, x0, p, maxiter, tol_chi2):
    """Iterate ``live_step(x) -> (x_new, (covn, norm), chi2, nbad)``.

    Semantics of the reference's scan loop: each iteration measures chi2
    at the pre-step state and applies the step; a non-finite chi2 freezes
    the state and ends the loop; |chi2_prev - chi2| < tol * max(chi2, 1)
    marks convergence after that step.  Returns (x, chi2, (covn, norm),
    converged, nbads, bad) with ``bad`` True when a chi2 was non-finite."""
    x = x0
    chi2_prev = math.inf
    cov = (torch.zeros((p, p), dtype=F64, device=x0.device),
           torch.ones((p,), dtype=F64, device=x0.device))
    converged = False
    bad = False
    nbads = []
    for _ in range(maxiter):
        x_new, cov_new, chi2_t, nbad = live_step(x)
        chi2 = float(chi2_t)  # one host sync per iteration
        nbads.append(int(nbad))
        if not math.isfinite(chi2):
            bad = True
            break
        conv = abs(chi2_prev - chi2) < tol_chi2 * max(chi2, 1.0)
        x, chi2_prev, cov = x_new, chi2, cov_new
        if conv:
            converged = True
            break
    return x, chi2_prev, cov, converged, nbads, bad


class Fitter:
    """Common base: compiled kernels + offset column + post-fit commit."""

    def __init__(self, model, toas, device=None):
        self.model = model
        self.toas = toas
        self.cm = model.compile(toas, device=device)
        self.device = self.cm.device
        self.converged = False
        self.parameter_covariance_matrix: np.ndarray | None = None
        self.chi2: float | None = None

    @property
    def _noffset(self) -> int:
        return noffset(self.cm)

    @staticmethod
    def _unnorm_cov(cov) -> np.ndarray:
        """(covn, norm) -> covn / outer(norm, norm) in host IEEE f64."""
        covn, norm = (c.detach().cpu().numpy() for c in cov)
        return covn / np.outer(norm, norm)

    def _finish_fit(self, result, warn_msg: str, fail_msg: str) -> float:
        x, chi2, cov, conv, nbads, bad = result
        for nb in nbads:
            if nb > 0:
                warnings.warn(f"{nb} {warn_msg}", DegeneracyWarning)
        if bad:
            raise ConvergenceFailure(fail_msg)
        self.converged = bool(conv)
        no = self._noffset
        cov = self._unnorm_cov(cov)[no:, no:]
        sigmas = np.sqrt(np.diag(cov))
        self.parameter_covariance_matrix = cov
        self.cm.commit(x.detach().cpu().numpy(), uncertainties=sigmas)
        self.chi2 = float(chi2)
        return self.chi2
