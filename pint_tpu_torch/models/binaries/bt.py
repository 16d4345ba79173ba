"""Blandford & Teukolsky (1976) binary delay.

Counterpart of ``pint_tpu/models/binaries/bt.py``: Keplerian Roemer and
Einstein delay with the first-order emission-time correction
Delta(t - Delta) ~= Delta (1 - dDelta/dt).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.binaries.kepler import kepler_solve


def bt_delay(M, nb, a1, ecc, omega, gamma):
    """BT delay (seconds); M the mean anomaly in [-pi, pi), nb the
    orbital angular frequency (rad/s), omega the longitude of periastron
    (rad)."""
    u = kepler_solve(M, ecc)
    su, cu = torch.sin(u), torch.cos(u)
    sw, cw = torch.sin(omega), torch.cos(omega)
    alpha = a1 * sw
    beta = a1 * torch.sqrt(torch.clamp_min(1.0 - ecc * ecc, 0.0)) * cw
    d = alpha * (cu - ecc) + (beta + gamma) * su
    ddot = nb * (-alpha * su + (beta + gamma) * cu) / (1.0 - ecc * cu)
    return d * (1.0 - ddot)
