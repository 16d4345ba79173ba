"""Per-parameter priors for Bayesian inference.

Counterpart of ``pint_tpu/models/priors.py`` (reference parity:
src/pint/models/priors.py::Prior + RV wrappers):
uniform/normal/bounded distributions attached to Parameters, consumed
by BayesianTiming (lnprior, prior_transform).
"""

from __future__ import annotations

import math

import numpy as np


class Prior:
    """Base prior: logpdf(x) and ppf(q) (inverse CDF for nested-sampling
    prior transforms)."""

    def logpdf(self, x):
        raise NotImplementedError

    def ppf(self, q):
        raise NotImplementedError


class UniformUnboundedRV(Prior):
    """Improper flat prior (the reference's default for fit params)."""

    def logpdf(self, x):
        return np.zeros_like(np.asarray(x, dtype=np.float64))

    def ppf(self, q):
        raise ValueError(
            "improper uniform prior has no prior transform; give the "
            "parameter bounds for nested sampling"
        )


class UniformBoundedRV(Prior):
    def __init__(self, lower: float, upper: float):
        if not upper > lower:
            raise ValueError("need upper > lower")
        self.lower, self.upper = float(lower), float(upper)
        self._logw = -math.log(upper - lower)

    def logpdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        inside = (x >= self.lower) & (x <= self.upper)
        return np.where(inside, self._logw, -np.inf)

    def ppf(self, q):
        return self.lower + (self.upper - self.lower) * np.asarray(q)


class NormalRV(Prior):
    def __init__(self, mean: float, sigma: float):
        self.mean, self.sigma = float(mean), float(sigma)

    def logpdf(self, x):
        z = (np.asarray(x, dtype=np.float64) - self.mean) / self.sigma
        return -0.5 * z * z - math.log(
            self.sigma * math.sqrt(2.0 * math.pi)
        )

    def ppf(self, q):
        from scipy.stats import norm

        return self.mean + self.sigma * norm.ppf(np.asarray(q))


def default_prior(param) -> Prior:
    """Reference behavior: normal around the par-file value when an
    uncertainty exists (scaled wide), else improper uniform."""
    if param.uncertainty:
        return NormalRV(0.0, 10.0 * abs(param.internal_uncertainty()))
    return UniformUnboundedRV()
