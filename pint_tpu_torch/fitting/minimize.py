"""Derivative-free and quasi-Newton chi2 minimization.

Counterpart of ``pint_tpu/fitting/minimize.py`` (the reference's
``PowellFitter``): ``scipy.optimize.minimize`` on the host over the
port's white chi2 of x, for problems where the Gauss-Newton step
misbehaves.  The gradient methods ('BFGS', 'L-BFGS-B', ...) take exact
derivatives from ``torch.func.jacfwd`` of the chi2 (the double-double
cores carry forward-mode rules, as the design matrix needs, and no
reverse-mode ones; with p free parameters the gradient is one p-tangent
forward pass); Powell and Nelder-Mead use none.
The uncertainties come from the WLS covariance at the optimum.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize
from torch.func import jacfwd

from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import CorrelatedErrors
from pint_tpu_torch.fitting.base import Fitter, design_with_offset
from pint_tpu_torch.fitting.wls import _wls_step, default_wls_method

#: the methods that take no derivatives
DERIVATIVE_FREE = ("Powell", "Nelder-Mead")


class MinimizeFitter(Fitter):
    """scipy.optimize.minimize over the chi2 kernel: ``method='Powell'``
    is the reference's PowellFitter; the gradient methods get
    ``torch.func.jacfwd`` of the chi2.  Refuses a model with correlated
    noise (its chi2 is the white one)."""

    def __init__(self, toas, model, method: str = "Powell", *, device=None):
        super().__init__(toas, model, device=device)
        if self.cm.has_correlated_errors:
            raise CorrelatedErrors(model)
        self.method = method

    def _tensor(self, v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=F64,
                               device=self.device)

    def fit_toas(self, maxiter: int = 2000) -> float:
        cm = self.cm
        kw = {}
        if self.method not in DERIVATIVE_FREE:
            dchi2 = jacfwd(cm.chi2)
            kw["jac"] = lambda v: dchi2(self._tensor(v)).cpu().numpy()
        res = minimize(
            lambda v: float(cm.chi2(self._tensor(v))),
            np.zeros(cm.nfree),
            method=self.method,
            options={"maxiter": maxiter},
            **kw,
        )
        self.converged = bool(res.success)
        # uncertainties from the Gauss-Newton covariance at the optimum
        x = self._tensor(res.x)
        M = design_with_offset(cm, x)
        w = 1.0 / torch.square(cm.scaled_sigma(x))
        _, cov, _ = _wls_step(
            torch.zeros(cm.bundle.ntoa, dtype=F64, device=self.device), M,
            w, method=default_wls_method(self.device), normalized_cov=True)
        return self._finalize(x, cov, float(res.fun))


class PowellFitter(MinimizeFitter):
    """The reference's name for ``MinimizeFitter(method='Powell')``."""

    def __init__(self, toas, model, *, device=None):
        super().__init__(toas, model, method="Powell", device=device)
