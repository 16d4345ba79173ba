"""Closed-form astrophysical quantities from timing parameters.

Counterpart of ``pint_tpu/derived_quantities.py``, a copy of its numpy
formulas (reference parity: src/pint/derived_quantities.py): mass functions,
companion/pulsar masses, characteristic age, magnetic fields, P<->F
conversions, GR post-Keplerian predictions.  Internal units: SI seconds
/ Hz / solar masses; angles in radians unless noted.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import C, SECS_PER_DAY, SECS_PER_JULIAN_YEAR, TSUN

_TWO_PI = 2.0 * np.pi


def p_to_f(p, pd=None, pdd=None):
    """Period (s) [, derivatives] -> frequency (Hz) [, derivatives]."""
    f = 1.0 / p
    if pd is None:
        return f
    fd = -pd / (p * p)
    if pdd is None:
        return f, fd
    fdd = 2.0 * pd * pd / p**3 - pdd / (p * p)
    return f, fd, fdd


def pferrs(p, p_err, pd=None, pd_err=None):
    """(P, Perr[, Pdot, Pdoterr]) -> (F, Ferr[, Fdot, Fdoterr]);
    first-order error propagation (reference: utils.pferrs)."""
    f = 1.0 / p
    f_err = p_err / (p * p)
    if pd is None:
        return f, f_err
    fd = -pd / (p * p)
    fd_err = np.sqrt(
        (pd_err / p**2) ** 2 + (2.0 * pd * p_err / p**3) ** 2
    )
    return f, f_err, fd, fd_err


def pulsar_age(f0, f1, n=3.0, fo=1e99):
    """Characteristic age (yr): tau = -f/((n-1) fdot) (1-(f/fo)^(n-1))."""
    tau_s = -f0 / ((n - 1.0) * f1) * (1.0 - (f0 / fo) ** (n - 1.0))
    return tau_s / SECS_PER_JULIAN_YEAR


def pulsar_B(f0, f1):
    """Surface dipole field (Gauss): 3.2e19 sqrt(-Pdot P)."""
    p, pd = 1.0 / f0, -f1 / (f0 * f0)
    return 3.2e19 * np.sqrt(np.maximum(pd, 0.0) * p)


def pulsar_B_lightcyl(f0, f1):
    """Field at the light cylinder (Gauss); reference formula
    2.9e8 Pdot^0.5 P^-5/2."""
    p, pd = 1.0 / f0, -f1 / (f0 * f0)
    return 2.9e8 * np.sqrt(np.maximum(pd, 0.0)) * p ** (-2.5)


def pulsar_edot(f0, f1, I=1e45):
    """Spin-down luminosity (erg/s): -4 pi^2 I f fdot."""
    return -4.0 * np.pi**2 * I * f0 * f1


def mass_funct(pb_s, a1_ls):
    """Mass function (Msun): 4 pi^2 x^3 / (G Pb^2), with x in
    light-seconds and Tsun = G Msun / c^3."""
    return _TWO_PI**2 * a1_ls**3 / (pb_s**2) / TSUN


def mass_funct2(mp, mc, inc_rad):
    """(mc sin i)^3 / (mp+mc)^2 in Msun."""
    return (mc * np.sin(inc_rad)) ** 3 / (mp + mc) ** 2


def companion_mass(pb_s, a1_ls, inc_rad=np.pi / 3, mp=1.4):
    """Solve the mass function for mc (Newton iteration)."""
    mf = mass_funct(pb_s, a1_ls)
    sini = np.sin(inc_rad)
    mc = np.maximum(mf, 0.05) ** (1.0 / 3.0) * (mp + 0.5) ** (2.0 / 3.0) / sini
    for _ in range(50):
        g = (mc * sini) ** 3 / (mp + mc) ** 2 - mf
        dg = (
            3.0 * sini**3 * mc**2 / (mp + mc) ** 2
            - 2.0 * (mc * sini) ** 3 / (mp + mc) ** 3
        )
        mc = mc - g / dg
    return mc


def pulsar_mass(pb_s, a1_ls, mc, inc_rad):
    """Solve the mass function for mp given mc."""
    mf = mass_funct(pb_s, a1_ls)
    return (mc * np.sin(inc_rad)) ** 1.5 / np.sqrt(mf) - mc


def omdot(mp, mc, pb_s, ecc):
    """GR periastron advance (deg/yr)."""
    nb = _TWO_PI / pb_s
    w = (
        3.0 * nb ** (5.0 / 3.0)
        * (TSUN * (mp + mc)) ** (2.0 / 3.0)
        / (1.0 - ecc**2)
    )  # rad/s
    return np.rad2deg(w) * SECS_PER_JULIAN_YEAR


def gamma(mp, mc, pb_s, ecc):
    """GR Einstein-delay amplitude (s)."""
    nb = _TWO_PI / pb_s
    return (
        ecc * nb ** (-1.0 / 3.0) * TSUN ** (2.0 / 3.0)
        * (mp + mc) ** (-4.0 / 3.0) * mc * (mp + 2.0 * mc)
    )


def pbdot(mp, mc, pb_s, ecc):
    """GR orbital decay (s/s)."""
    nb = _TWO_PI / pb_s
    e2 = ecc * ecc
    fe = (1.0 + 73.0 / 24.0 * e2 + 37.0 / 96.0 * e2 * e2) / (
        1.0 - e2
    ) ** 3.5
    return (
        -192.0 * np.pi / 5.0 * nb ** (5.0 / 3.0) * fe
        * TSUN ** (5.0 / 3.0) * mp * mc * (mp + mc) ** (-1.0 / 3.0)
    )


def sini_gr(mp, mc, pb_s, a1_ls):
    """GR Shapiro shape: s = x nb^(2/3) (Tsun)^(-1/3) (mp+mc)^(2/3)/mc."""
    nb = _TWO_PI / pb_s
    return (
        a1_ls * nb ** (2.0 / 3.0) * TSUN ** (-1.0 / 3.0)
        * (mp + mc) ** (2.0 / 3.0) / mc
    )


def shklovskii_factor(pmtot_rad_s, d_kpc):
    """Apparent Pdot/P from transverse motion: mu^2 d / c (1/s)."""
    d_m = d_kpc * 3.0856775814913673e19
    return pmtot_rad_s**2 * d_m / C


def dispersion_slope(dm):
    """DM (pc/cm^3) -> slope in s MHz^2 (tempo convention K*DM)."""
    from pint_tpu_torch.constants import DM_CONST

    return DM_CONST * dm


def pb_from_fb0(fb0):
    """FB0 (1/s) -> PB (days)."""
    return 1.0 / fb0 / SECS_PER_DAY
