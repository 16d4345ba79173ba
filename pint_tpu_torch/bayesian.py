"""Bayesian timing: log-likelihood, log-prior, prior transform.

Counterpart of ``pint_tpu/bayesian.py`` (reference parity:
src/pint/bayesian.py::BayesianTiming).  The log-posterior is a function
of the delta vector x alone, so ``torch.func.vmap`` runs it over walkers
or nested-sampling candidates as one batched computation, and
``CompiledModel.program`` makes that one step program (CUDA graphs on
the card, ``runtime/graphs.py``).

Correlated noise (power-law red noise, ECORR, ...) is marginalized with
the Woodbury identity the GLS fitter factorizes through: lnL = -1/2
[r^T C^-1 r + ln det C + n ln 2pi] with C = N + T phi T^T, evaluated
through a k x k Cholesky factor, never an n x n array.  Noise
hyperparameters marked free in the par file (TNREDAMP, EFAC, ...) enter
x and are sampled too.  The Cholesky factor is ``ops/ffgram.py::
nan_cholesky``: a proposal outside the physical range gives a NaN
likelihood, which the samplers reject, where ``torch.linalg.cholesky``
would raise (and read its status on the host).

The priors act on x (deltas from the par-file values, internal units),
the fitters' parameterization.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch.fitting.gls import woodbury_sigma
from pint_tpu_torch.models.priors import (
    NormalRV,
    Prior,
    UniformBoundedRV,
    default_prior,
)
from pint_tpu_torch.ops.ffgram import nan_cholesky
from pint_tpu_torch.runtime.guard import check_deadlines

_LOG_2PI = math.log(2.0 * math.pi)


def lnlikelihood_cm(cm, x):
    """Gaussian likelihood of the timing residuals of one compiled model
    at x (vmap-safe, no host read).

    White noise: diagonal.  Correlated noise: rCr = r N^-1 r - z^T z with
    z = L^-1 T^T N^-1 r, L the Cholesky factor of Sigma = phi^-1 +
    T^T N^-1 T (``fitting/gls.py::woodbury_sigma``, the fitters' own
    assembly), and ln det C = ln det N + ln det phi + ln det Sigma."""
    r = cm.time_residuals(x)
    sig = cm.scaled_sigma(x)
    n = r.shape[-1]
    if not cm.has_correlated_errors:
        return (-0.5 * torch.sum(torch.square(r / sig))
                - torch.sum(torch.log(sig)) - 0.5 * n * _LOG_2PI)
    T, phi = cm.noise_basis_or_empty(x)
    Ninv, _TN, Sigma = woodbury_sigma(torch.square(sig), T, phi)
    Ninv_r = r * Ninv
    L = nan_cholesky(Sigma)
    z = torch.linalg.solve_triangular(
        L, (T.T @ Ninv_r)[:, None], upper=False)[:, 0]
    rCr = torch.dot(r, Ninv_r) - torch.dot(z, z)
    logdet_C = (2.0 * torch.sum(torch.log(sig)) + torch.sum(torch.log(phi))
                + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return -0.5 * (rCr + logdet_C + n * _LOG_2PI)


def make_lnprior(priors: dict, param_names):
    """-> lnprior(x): the sum of the per-parameter log-priors over the
    x-space deltas (uniform bounds, normal; an improper uniform adds 0),
    as tensor operations with no host read."""
    names = list(param_names)

    def lnprior(x):
        out = torch.zeros((), dtype=x.dtype, device=x.device)
        for i, n in enumerate(names):
            p = priors[n]
            xi = x[..., i]
            if isinstance(p, NormalRV):
                z = (xi - p.mean) / p.sigma
                out = out - 0.5 * z * z - math.log(
                    p.sigma * math.sqrt(2.0 * math.pi))
            elif isinstance(p, UniformBoundedRV):
                out = out + torch.where(
                    (xi >= p.lower) & (xi <= p.upper),
                    torch.full_like(xi, p._logw),
                    torch.full_like(xi, -math.inf))
        return out

    return lnprior


def default_priors_for(model, param_names) -> dict:
    """name -> ``default_prior(param)`` for every free name."""
    return {n: default_prior(model.params[n]) for n in param_names}


class BayesianTiming:
    """Likelihood, prior and posterior of a timing model over x.
    ``device`` (keyword-only; None: the CUDA card) is where the model is
    compiled and every evaluation runs."""

    def __init__(self, model, toas, priors: Optional[dict] = None, *,
                 device=None):
        self.model = model
        self.toas = toas
        self.cm = model.compile(toas, device=device)
        self.device = self.cm.device
        self.param_names = list(self.cm.free_names)
        self.nparams = len(self.param_names)
        self.priors: dict[str, Prior] = {}
        for n in self.param_names:
            if priors and n in priors:
                self.priors[n] = priors[n]
            else:
                self.priors[n] = default_prior(model.params[n])
        self._lnprior = make_lnprior(self.priors, self.param_names)

    def _x(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    # -- pieces -----------------------------------------------------------
    def lnlikelihood(self, x):
        """Gaussian likelihood of the timing residuals
        (:func:`lnlikelihood_cm`)."""
        return lnlikelihood_cm(self.cm, self._x(x))

    def lnprior(self, x):
        """Sum of the per-parameter log-priors."""
        return self._lnprior(self._x(x))

    def lnposterior(self, x):
        x = self._x(x)
        return self._lnprior(x) + lnlikelihood_cm(self.cm, x)

    def prior_transform(self, cube):
        """Unit hypercube -> x (for nested samplers); host numpy."""
        cube = np.atleast_1d(np.asarray(cube, dtype=np.float64))
        return np.array([
            self.priors[n].ppf(cube[i])
            for i, n in enumerate(self.param_names)
        ])

    def lnposterior_jit(self):
        """The log-posterior of one x as a step program of the compiled
        model (the reference's ``cm.jit(self.lnposterior)``)."""
        return self.cm.program(self.lnposterior,
                               ("lnposterior", self.nparams))

    def lnposterior_batch(self, nbatch: int):
        """The log-posterior vmapped over ``nbatch`` points, as one step
        program: (nbatch, nparams) -> (nbatch,)."""
        return self.cm.program(torch.func.vmap(self.lnposterior),
                               ("lnposterior", nbatch, self.nparams))

    def loglike_batch(self, nbatch: int):
        """The log-likelihood vmapped over ``nbatch`` points, as one step
        program."""
        return self.cm.program(torch.func.vmap(self.lnlikelihood),
                               ("lnlikelihood", nbatch, self.nparams))

    def sample_nested(self, nlive: int = 200, dlogz: float = 0.1,
                      seed: int = 0, batch: int = 128, **kw):
        """Nested sampling of the timing posterior: ``prior_transform``
        and the vmapped log-likelihood through ``pint_tpu_torch.nested``.
        Every call's points are scored by one step program of ``batch``
        points, a replay for each ``batch`` of them (the sampler's
        proposals come padded to that length; the initial live set is
        cut into such batches, the last padded).  Every prior must be
        proper."""
        from pint_tpu_torch.nested import nested_sample

        prog = self.loglike_batch(batch)

        def loglike_batch(X):
            X = np.asarray(X, dtype=np.float64)
            out = []
            for lo in range(0, len(X), batch):
                block = X[lo:lo + batch]
                pad = batch - len(block)
                if pad:
                    block = np.concatenate(
                        [block, np.repeat(block[-1:], pad, 0)])
                out.append(prog(self._x(block))[:batch - pad])
            check_deadlines(wait=True)  # as the grid's host read
            return torch.cat(out).cpu().numpy()

        return nested_sample(
            loglike_batch, self.prior_transform, self.nparams,
            nlive=nlive, dlogz=dlogz, seed=seed, batch=batch, **kw,
        )
