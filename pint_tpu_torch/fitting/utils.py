"""Fitter statistics helpers.

A copy of ``pint_tpu/fitting/utils.py`` (numpy and scipy only):
significance of adding parameters to a nested timing model.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import f as f_dist


def ftest(chi2_1: float, dof_1: int, chi2_2: float, dof_2: int) -> float:
    """F-test probability that the chi2 improvement of the larger model
    (2, with dof_2 < dof_1) arises by chance.

    Returns the p-value (small = the extra parameters are significant);
    NaN when the inputs are not a valid nested comparison.
    """
    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_dof <= 0 or dof_2 <= 0 or delta_chi2 < 0:
        return float("nan")
    F = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(f_dist.sf(F, delta_dof, dof_2))


def akaike_information_criterion(chi2: float, nfree: int) -> float:
    """AIC = chi2 + 2 k (up to a model-independent constant)."""
    return float(chi2 + 2 * nfree)


def parameter_correlation_matrix(cov: np.ndarray) -> np.ndarray:
    """Normalize a parameter covariance matrix to correlations."""
    s = np.sqrt(np.diag(cov))
    s = np.where(s == 0, 1.0, s)
    return cov / np.outer(s, s)
