"""Kepler-equation solve and anomaly conversions.

Counterpart of ``pint_tpu/models/binaries/kepler.py``: the Newton
iteration runs exactly 8 times with no data-dependent exit (quadratic
convergence from E0 = M + e sin M reaches f64 precision for e < 0.97), so
``torch.func.jacfwd`` differentiates through straight-line code.
"""

from __future__ import annotations

import torch


def kepler_solve(M, ecc, iters: int = 8):
    """Eccentric anomaly u solving u - e sin(u) = M (M in [-pi, pi))."""
    u = M + ecc * torch.sin(M)
    for _ in range(iters):
        u = u - (u - ecc * torch.sin(u) - M) / (1.0 - ecc * torch.cos(u))
    return u


def true_anomaly(u, ecc):
    """True anomaly nu from eccentric anomaly u (same branch as u)."""
    return 2.0 * torch.atan2(
        torch.sqrt(1.0 + ecc) * torch.sin(0.5 * u),
        torch.sqrt(1.0 - ecc) * torch.cos(0.5 * u),
    )
