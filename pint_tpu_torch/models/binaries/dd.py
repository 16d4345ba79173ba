"""Damour & Deruelle (1986) binary delays.

Counterpart of ``pint_tpu/models/binaries/dd.py``: Roemer delay with the
periastron advance omega = OM + k nu (k = OMDOT/n), the relativistic
deformations er/eth, the Einstein delay folded into the inverse-timing
expansion (DD paper eqs. 46-52), the Shapiro log delay and the A0/B0
aberration terms; and the GR post-Keplerian parameters of DDGR.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.models.binaries.kepler import kepler_solve, true_anomaly

TWOPI = 2.0 * math.pi


def dd_delay(M, norbit, nb, a1, ecc, om0, k, gamma=0.0, m2r=0.0, sini=0.0,
             dr=0.0, dth=0.0, a0=0.0, b0=0.0, use_shapiro=True):
    """DD delay (seconds).  M: mean anomaly in [-pi, pi); norbit: integer
    orbit count (for the cumulative true anomaly of the periastron
    advance); nb: orbital angular frequency; m2r = TSUN M2 (s)."""
    u = kepler_solve(M, ecc)
    su, cu = torch.sin(u), torch.cos(u)
    nu = true_anomaly(u, ecc)
    omega = om0 + k * (nu + TWOPI * norbit)
    sw, cw = torch.sin(omega), torch.cos(omega)
    er = ecc * (1.0 + dr)
    eth = ecc * (1.0 + dth)
    alpha = a1 * sw
    beta = a1 * torch.sqrt(torch.clamp_min(1.0 - eth * eth, 0.0)) * cw
    dre = alpha * (cu - er) + (beta + gamma) * su
    drep = -alpha * su + (beta + gamma) * cu
    drepp = -alpha * cu - (beta + gamma) * su
    onemecu = 1.0 - ecc * cu
    anhat = nb / onemecu
    nd = anhat * drep
    d = dre * (
        1.0 - nd + nd * nd
        + 0.5 * anhat * anhat * dre * drepp
        - 0.5 * ecc * su / onemecu * anhat * anhat * dre * drep
    )
    if use_shapiro:
        brace = onemecu - sini * (
            sw * (cu - ecc)
            + torch.sqrt(torch.clamp_min(1.0 - ecc * ecc, 0.0)) * cw * su
        )
        d = d - 2.0 * m2r * torch.log(torch.clamp_min(brace, 1e-30))
    return d + a0 * (torch.sin(omega + nu) + ecc * sw) + b0 * (
        torch.cos(omega + nu) + ecc * cw
    )


def gr_pk_params(pb_s, ecc, a1, mtot_s, m2_s):
    """GR post-Keplerian parameters from the masses (DDGR), all masses in
    seconds (GM/c^3): dict of k (omdot = k n), gamma, pbdot, dr, dth and
    sini."""
    n = TWOPI / pb_s
    m1 = mtot_s - m2_s
    mn23 = (mtot_s * n) ** (2.0 / 3.0)
    e2 = ecc * ecc
    k = 3.0 * mn23 / (1.0 - e2)
    gamma = ecc / n * mn23 * m2_s * (m1 + 2.0 * m2_s) / (mtot_s * mtot_s)
    pbdot = (
        -192.0 * math.pi / 5.0
        * (n * mtot_s) ** (5.0 / 3.0)
        * (m1 * m2_s / (mtot_s * mtot_s))
        * (1.0 + (73.0 / 24.0) * e2 + (37.0 / 96.0) * e2 * e2)
        * (1.0 - e2) ** (-3.5)
    )
    dr = (3.0 * m1 * m1 + 6.0 * m1 * m2_s + 2.0 * m2_s * m2_s) / (
        mtot_s * mtot_s
    ) * mn23
    dth = (3.5 * m1 * m1 + 6.0 * m1 * m2_s + 2.0 * m2_s * m2_s) / (
        mtot_s * mtot_s
    ) * mn23
    sini = a1 * n ** (2.0 / 3.0) * mtot_s ** (2.0 / 3.0) / m2_s
    return {"k": k, "gamma": gamma, "pbdot": pbdot, "dr": dr, "dth": dth,
            "sini": sini}
