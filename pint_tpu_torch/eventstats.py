"""Photon-phase periodicity statistics: Z^2_m, H-test.

Counterpart of ``pint_tpu/eventstats.py`` (reference parity:
src/pint/eventstats.py::z2m, hm, sf_z2m, sf_hm; de Jager, Raubenheimer &
Swanepoel 1989; de Jager & Busching 2010 for the H-test tail).  The
trigonometric sums over the photons run in f64 on ``device`` (None: the
CUDA card, or the device of a tensor of phases); the statistics come
back as numpy, the tail probabilities are host scipy.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import chi2 as _chi2

from pint_tpu_torch.device import F64, resolve_device


def _on_device(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(F64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=resolve_device(device))


def z2m(phases, m: int = 2, weights=None, *, device=None):
    """Z^2_m statistics for harmonics 1..m; returns the array of the
    cumulative Z^2_k for k = 1..m (weighted form, Kerr 2011:
    Z^2_k = 2 / sum(w^2) |sum w e^{ik phi}|^2)."""
    ph = 2.0 * np.pi * _on_device(phases, device)
    w = torch.ones_like(ph) if weights is None else _on_device(
        weights, ph.device)
    norm = torch.sum(w * w)
    ks = torch.arange(1, m + 1, dtype=F64, device=ph.device)
    arg = ks[:, None] * ph[None, :]
    c = torch.sum(w[None, :] * torch.cos(arg), dim=1)
    s = torch.sum(w[None, :] * torch.sin(arg), dim=1)
    return torch.cumsum(2.0 / norm * (c * c + s * s), 0).cpu().numpy()


def sf_z2m(z2, m: int = 2):
    """Survival function of Z^2_m (chi^2 with 2m dof)."""
    return float(_chi2.sf(z2, 2 * m))


def hm(phases, m: int = 20, weights=None, *, device=None):
    """H-test statistic: max_k (Z^2_k - 4k + 4) over k = 1..m."""
    z = z2m(phases, m=m, weights=weights, device=device)
    ks = np.arange(1, m + 1)
    return float(np.max(z - 4.0 * ks + 4.0))


def h2sig(h):
    """H-test significance in sigma (de Jager & Busching 2010:
    p = exp(-0.4 H))."""
    from scipy.stats import norm

    logp = -0.4 * h
    return float(norm.isf(np.exp(logp))) if logp > -700 else float(
        norm.isf(0.0)
    )


def sf_hm(h):
    """H-test tail probability exp(-0.4 H) (de Jager & Busching 2010)."""
    return float(np.exp(-0.4 * h))
