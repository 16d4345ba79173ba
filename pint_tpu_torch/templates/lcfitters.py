"""Maximum-likelihood template fitting of photon phases.

Counterpart of ``pint_tpu/templates/lcfitters.py`` (reference parity:
src/pint/templates/lcfitters.py::LCFitter): the unbinned (optionally
weighted) log-likelihood as a torch function of the parameter vector on
the phases' device, its gradient by ``torch.autograd`` fed to scipy
L-BFGS-B on the host, and the errors from ``torch.func.hessian``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize

from pint_tpu_torch.device import F64, resolve_device
from pint_tpu_torch.templates.lctemplate import LCTemplate


def _on(a, dev):
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=F64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


class LCFitter:
    """``device`` (keyword-only; None: the CUDA card, or the device of a
    tensor of phases) is where the photons live and every likelihood
    evaluation runs."""

    def __init__(self, template: LCTemplate, phases, weights=None,
                 log10_ens=None, *, device=None):
        self.template = template
        dev = (phases.device if isinstance(phases, torch.Tensor)
               and device is None else resolve_device(device))
        self.device = dev
        self.phases = _on(phases, dev)
        self.weights = None if weights is None else _on(weights, dev)
        self.log10_ens = None if log10_ens is None else _on(log10_ens, dev)
        if self.log10_ens is None and getattr(
            template, "is_energy_dependent", False
        ):
            # without energies the slope parameters have exactly zero
            # gradient: the fit would silently equal the energy-blind
            # one and errors() would invert a singular Hessian
            raise ValueError(
                "template has energy-dependent primitives; pass "
                "log10_ens (per-photon log10(E/GeV))"
            )

    def _params(self, params):
        if params is None:
            params = self.template.get_parameters()
        return _on(params, self.device)

    def loglikelihood(self, params=None):
        """Unbinned log-likelihood (weighted form: Kerr 2011 eq. 2), a 0-d
        tensor on the fitter's device."""
        f = self.template(
            self.phases, params=self._params(params),
            log10_ens=self.log10_ens
        )
        if self.weights is None:
            return torch.sum(torch.log(torch.clamp(f, min=1e-300)))
        return torch.sum(torch.log(torch.clamp(
            self.weights * f + (1.0 - self.weights), min=1e-300)))

    def _objective(self, v):
        """(-loglikelihood, its gradient) at the numpy vector v."""
        t = torch.tensor(v, dtype=F64, device=self.device,
                         requires_grad=True)
        val = -self.loglikelihood(params=t)
        (g,) = torch.autograd.grad(val, t)
        return float(val.detach()), g.cpu().numpy()

    def fit(self, maxiter: int = 200):
        """L-BFGS-B with autograd gradients; bounds keep weights in
        [0, 1] and widths positive.  Returns the optimized
        log-likelihood."""
        x0 = self.template.get_parameters()
        n = len(self.template.primitives)
        bounds = [(1e-6, 1.0)] * n
        for p in self.template.primitives:
            bounds += p.fit_bounds()

        res = minimize(
            self._objective,
            x0,
            jac=True,
            method="L-BFGS-B",
            bounds=bounds,
            options={"maxiter": maxiter},
        )
        self.template.set_parameters(res.x)
        # wrap fitted locations into [0, 1)
        for p in self.template.primitives:
            p.wrap_loc()
        self.result = res
        return -float(res.fun)

    def errors(self):
        """Parameter uncertainties from the observed information: the
        Hessian of -loglikelihood at the fitted parameters
        (``torch.func.hessian``), pseudo-inverted (weight parameters
        pinned at a bound get a 0 eigenvalue rather than a spurious tiny
        error).  Reference: LCFitter's hess_errors.  Stored on the
        template as .param_errors (get_parameters() layout) and
        returned."""
        v0 = self._params(None)
        H = torch.func.hessian(
            lambda v: -self.loglikelihood(params=v))(v0).cpu().numpy()
        cov = np.linalg.pinv(H, rcond=1e-12)
        err = np.sqrt(np.maximum(np.diag(cov), 0.0))
        self.template.param_errors = err
        return err

    def __repr__(self):
        return f"LCFitter({self.template!r}, n={len(self.phases)})"
