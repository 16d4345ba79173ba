"""ELL1-family binary delays (small-eccentricity expansion).

Counterpart of ``pint_tpu/models/binaries/ell1.py``: Lange et al. 2001's
Roemer delay to first order in eccentricity, the emission-time (inverse
timing) correction, and the Shapiro delay in (M2, SINI) or orthometric
(H3, H4/STIGMA; Freire & Wex 2010) form.  All are f64 kernels of the
orbital longitude ``phi`` (from DD orbit counting, ``orbits.py``) and
scalar parameters in internal units (seconds, radians, dimensionless).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.ops.scalarmath import arctan2_p


def roemer_terms(phi, a1, eps1, eps2):
    """ELL1 Roemer delay and its first two phi-derivatives:
    Dre = a1 [sin(phi) + (eps2/2) sin(2 phi) - (eps1/2) cos(2 phi)]."""
    s, c = torch.sin(phi), torch.cos(phi)
    s2, c2 = torch.sin(2.0 * phi), torch.cos(2.0 * phi)
    dre = a1 * (s + 0.5 * (eps2 * s2 - eps1 * c2))
    drep = a1 * (c + eps2 * c2 + eps1 * s2)
    drepp = a1 * (-s + 2.0 * (eps1 * c2 - eps2 * s2))
    return dre, drep, drepp


def inverse_timing(dre, drep, drepp, nb):
    """Dre' = Dre (1 - nb Drep + (nb Drep)^2 + 1/2 nb^2 Dre Drepp)."""
    nbdrep = nb * drep
    return dre * (1.0 - nbdrep + nbdrep * nbdrep
                  + 0.5 * nb * nb * dre * drepp)


def shapiro_ms(phi, m2_tsun, sini):
    """-2 r ln(1 - s sin phi), r = TSUN M2 in seconds."""
    arg = 1.0 - sini * torch.sin(phi)
    return -2.0 * m2_tsun * torch.log(torch.clamp_min(arg, 1e-30))


def shapiro_h3_stig(phi, h3, stig):
    """Orthometric Shapiro: r = h3 / stig^3, s = 2 stig / (1 + stig^2)."""
    r = h3 / (stig * stig * stig)
    s = 2.0 * stig / (1.0 + stig * stig)
    return shapiro_ms(phi, r, s)


def shapiro_h3_only(phi, h3):
    """Third harmonic only: -(4/3) h3 sin(3 phi) (Freire & Wex 2010 eq.
    19)."""
    return -(4.0 / 3.0) * h3 * torch.sin(3.0 * phi)


def eps_at_t(dt_f, eps1, eps2, eps1dot=0.0, eps2dot=0.0):
    """Laplace-Lagrange parameters linear in time (ELL1)."""
    return eps1 + eps1dot * dt_f, eps2 + eps2dot * dt_f


def eps_at_t_k(dt_f, eps1_0, eps2_0, omdot=0.0, lnedot=0.0):
    """ELL1k (Susobhanan et al. 2018): e(t) = e0 (1 + lnedot dt),
    omega(t) = omega0 + omdot dt."""
    om0 = arctan2_p(eps1_0, eps2_0)
    e0 = torch.sqrt(eps1_0 * eps1_0 + eps2_0 * eps2_0)
    e = e0 * (1.0 + lnedot * dt_f)
    om = om0 + omdot * dt_f
    return e * torch.sin(om), e * torch.cos(om)
