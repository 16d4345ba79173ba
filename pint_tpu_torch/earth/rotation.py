"""ITRF -> GCRS rotation: IAU1976 precession + truncated IAU1980
nutation + frame bias + GAST spin + polar motion.

Counterpart of ``pint_tpu/earth/rotation.py`` (PINT's
``erfautils.gcrs_posvel_from_itrf`` wraps ERFA's full IAU2000A
machinery).  The classical equinox-based chain is implemented directly:

  r_GCRS = B^T P^T(t) N^T(t) R3(-GAST) W^T(t) r_ITRF

with the nutation series truncated to the 54 largest IAU1980 terms
(every term with |dpsi| >= 0.4 mas or |deps| >= 0.2 mas).  The ~52
omitted terms are each <= 0.3 mas with RSS < ~0.7 mas, so the series
is ~1 mas-class vs full IAU1980 — the same class as IAU2000B vs
IAU2000A (the reference's full machinery).  1 mas of orientation is
~3 cm of observatory position ~ 0.1 ns of timing; IAU1980 itself
differs from IAU2000A by a further ~3 mas (updated amplitudes +
planetary nutation), which the frame-bias + EOP corrections absorb in
practice.  GAST includes the two largest complementary terms of the
equation of the equinoxes (IAU 2000 definition).

All functions are vectorized numpy over the TOA axis and run on the
host at ingest; the products reach the device as TOABundle geometry
columns.
"""

from __future__ import annotations

import numpy as np

ARCSEC = np.pi / (180.0 * 3600.0)
TWOPI = 2.0 * np.pi
# IERS conventional mean angular velocity of the Earth (rad/s)
OMEGA_EARTH = 7.292115855306589e-5  # derived from the ERA rate below
# ERA rate: revolutions per UT1 day
_ERA_RATE = 1.00273781191135448


def _r1(angle):
    c, s = np.cos(angle), np.sin(angle)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, c, s], -1),
        np.stack([z, -s, c], -1),
    ], -2)


def _r2(angle):
    c, s = np.cos(angle), np.sin(angle)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, z, -s], -1),
        np.stack([z, o, z], -1),
        np.stack([s, z, c], -1),
    ], -2)


def _r3(angle):
    c, s = np.cos(angle), np.sin(angle)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, z], -1),
        np.stack([-s, c, z], -1),
        np.stack([z, z, o], -1),
    ], -2)


# -- frame bias (GCRS -> mean J2000), IAU 2000 ---------------------------
_XI0 = -0.0166170 * ARCSEC
_ETA0 = -0.0068192 * ARCSEC
_DA0 = -0.01460 * ARCSEC


def bias_matrix():
    """B such that r_J2000mean = B r_GCRS."""
    return (_r1(np.float64(-_ETA0)) @ _r2(np.float64(_XI0))
            @ _r3(np.float64(_DA0)))


# -- IAU1976 precession ---------------------------------------------------
def precession_matrix(t_tt_cent):
    """P such that r_mean-of-date = P r_J2000 (IAU 1976)."""
    T = np.asarray(t_tt_cent, dtype=np.float64)
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * ARCSEC
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * ARCSEC
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * ARCSEC
    return _r3(-z) @ _r2(theta) @ _r3(-zeta)


def mean_obliquity(t_tt_cent):
    """IAU1980 mean obliquity of the ecliptic (rad)."""
    T = np.asarray(t_tt_cent, dtype=np.float64)
    return (
        84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3
    ) * ARCSEC


# -- IAU1980 nutation, largest 54 terms ----------------------------------
# rows: (l, l', F, D, Om multipliers, psi_0.1mas, psi_t, eps_0.1mas, eps_t)
_NUT_TERMS = np.array([
    [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
    [0, 0, 2, -2, 2, -13187.0, -1.6, 5736.0, -3.1],
    [0, 0, 2, 0, 2, -2274.0, -0.2, 977.0, -0.5],
    [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
    [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
    [1, 0, 0, 0, 0, 712.0, 0.1, -7.0, 0.0],
    [0, 1, 2, -2, 2, -517.0, 1.2, 224.0, -0.6],
    [0, 0, 2, 0, 1, -386.0, -0.4, 200.0, 0.0],
    [1, 0, 2, 0, 2, -301.0, 0.0, 129.0, -0.1],
    [0, -1, 2, -2, 2, 217.0, -0.5, -95.0, 0.3],
    [1, 0, 0, -2, 0, -158.0, 0.0, -1.0, 0.0],
    [0, 0, 2, -2, 1, 129.0, 0.1, -70.0, 0.0],
    [-1, 0, 2, 0, 2, 123.0, 0.0, -53.0, 0.0],
    [1, 0, 0, 0, 1, 63.0, 0.1, -33.0, 0.0],
    [0, 0, 0, 2, 0, 63.0, 0.0, -2.0, 0.0],
    [-1, 0, 2, 2, 2, -59.0, 0.0, 26.0, 0.0],
    [-1, 0, 0, 0, 1, -58.0, -0.1, 32.0, 0.0],
    [1, 0, 2, 0, 1, -51.0, 0.0, 27.0, 0.0],
    [-2, 0, 2, 0, 1, 46.0, 0.0, -24.0, 0.0],
    [0, 0, 2, 2, 2, -38.0, 0.0, 16.0, 0.0],
    [2, 0, 2, 0, 2, -31.0, 0.0, 13.0, 0.0],
    [2, 0, 0, 0, 0, 29.0, 0.0, -1.0, 0.0],
    [1, 0, 2, -2, 2, 29.0, 0.0, -12.0, 0.0],
    [0, 0, 2, 0, 0, 26.0, 0.0, -1.0, 0.0],
    [0, 0, 2, -2, 0, -22.0, 0.0, 0.0, 0.0],
    [-1, 0, 2, 0, 1, 21.0, 0.0, -10.0, 0.0],
    [0, 2, 0, 0, 0, 17.0, -0.1, 0.0, 0.0],
    [0, 2, 2, -2, 2, -16.0, 0.1, 7.0, 0.0],
    [-1, 0, 0, 2, 1, 16.0, 0.0, -8.0, 0.0],
    [0, 1, 0, 0, 1, -15.0, 0.0, 9.0, 0.0],
    [1, 0, 0, -2, 1, -13.0, 0.0, 7.0, 0.0],
    [0, -1, 0, 0, 1, -12.0, 0.0, 6.0, 0.0],
    [2, 0, -2, 0, 0, 11.0, 0.0, 0.0, 0.0],
    [-1, 0, 2, 2, 1, -10.0, 0.0, 5.0, 0.0],
    [1, 0, 2, 2, 2, -8.0, 0.0, 3.0, 0.0],
    [0, -1, 2, 0, 2, -7.0, 0.0, 3.0, 0.0],
    [0, 0, 2, 2, 1, -7.0, 0.0, 3.0, 0.0],
    [1, 1, 0, -2, 0, -7.0, 0.0, 0.0, 0.0],
    [0, 1, 2, 0, 2, 7.0, 0.0, -3.0, 0.0],
    [-2, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
    [0, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
    [2, 0, 2, -2, 2, 6.0, 0.0, -3.0, 0.0],
    [1, 0, 0, 2, 0, 6.0, 0.0, 0.0, 0.0],
    [1, 0, 2, -2, 1, 6.0, 0.0, -3.0, 0.0],
    [0, 0, 0, -2, 1, -5.0, 0.0, 3.0, 0.0],
    [0, -1, 2, -2, 1, -5.0, 0.0, 3.0, 0.0],
    [2, 0, 2, 0, 1, -5.0, 0.0, 3.0, 0.0],
    [1, -1, 0, 0, 0, 5.0, 0.0, 0.0, 0.0],
    [1, 0, 0, -1, 0, -4.0, 0.0, 0.0, 0.0],
    [0, 0, 0, 1, 0, -4.0, 0.0, 0.0, 0.0],
    [0, 1, 0, -2, 0, -4.0, 0.0, 0.0, 0.0],
    [1, 0, -2, 0, 0, 4.0, 0.0, 0.0, 0.0],
    [2, 0, 0, -2, 1, 4.0, 0.0, -2.0, 0.0],
    [0, 1, 2, -2, 1, 4.0, 0.0, -2.0, 0.0],
])


def fundamental_args(t_tt_cent):
    """Delaunay arguments l, l', F, D, Om (rad; IERS 2003 polynomials)."""
    T = np.asarray(t_tt_cent, dtype=np.float64)

    def poly(deg0, c1, c2, c3):
        return np.deg2rad(
            deg0 + (c1 * T + c2 * T**2 + c3 * T**3) / 3600.0
        )

    l = poly(134.96340251, 1717915923.2178, 31.8792, 0.051635)
    lp = poly(357.52910918, 129596581.0481, -0.5532, 0.000136)
    F = poly(93.27209062, 1739527262.8478, -12.7512, -0.001037)
    D = poly(297.85019547, 1602961601.2090, -6.3706, 0.006593)
    Om = poly(125.04455501, -6962890.5431, 7.4722, 0.007702)
    return l, lp, F, D, Om


def nutation_angles(t_tt_cent):
    """(dpsi, deps) in radians; truncated IAU1980 (54 largest terms,
    omitted-term RSS < 0.7 mas — see module docstring)."""
    T = np.asarray(t_tt_cent, dtype=np.float64)
    l, lp, F, D, Om = fundamental_args(T)
    args = np.stack([l, lp, F, D, Om], axis=-1)  # (..., 5)
    mult = _NUT_TERMS[:, :5]  # (k, 5)
    phase = np.tensordot(args, mult.T, axes=([-1], [0]))  # (..., k)
    psi_amp = (_NUT_TERMS[:, 5] + _NUT_TERMS[:, 6] * T[..., None])
    eps_amp = (_NUT_TERMS[:, 7] + _NUT_TERMS[:, 8] * T[..., None])
    dpsi = np.sum(psi_amp * np.sin(phase), axis=-1) * 1e-4 * ARCSEC
    deps = np.sum(eps_amp * np.cos(phase), axis=-1) * 1e-4 * ARCSEC
    return dpsi, deps


def nutation_matrix(t_tt_cent):
    """N such that r_true-of-date = N r_mean-of-date."""
    eps0 = mean_obliquity(t_tt_cent)
    dpsi, deps = nutation_angles(t_tt_cent)
    return _r1(-(eps0 + deps)) @ _r3(-dpsi) @ _r1(eps0)


# -- Earth rotation angle / sidereal time --------------------------------
def era(mjd_ut1):
    """Earth rotation angle (rad; IAU 2000 definition).

    Tu = JD(UT1) - 2451545.0 = MJD(UT1) - 51544.5; splitting Tu into
    day + fraction keeps the fast term at full f64 resolution.
    """
    mjd = np.asarray(mjd_ut1, dtype=np.float64)
    tu_day = np.floor(mjd) - 51544.0
    tu_frac = mjd - np.floor(mjd) - 0.5
    # ERA/2pi = 0.779... + 1.00273781191135448 Tu; the integer-day part
    # of 1.0*Tu drops out mod 1, leaving full resolution on the fraction
    turns = (
        0.7790572732640
        + 0.00273781191135448 * (tu_day + tu_frac)
        + tu_frac
    )
    return np.mod(turns, 1.0) * TWOPI


def gmst82(mjd_ut1):
    """Greenwich mean sidereal time, IAU1982 model (rad)."""
    mjd = np.asarray(mjd_ut1, dtype=np.float64)
    Tu = (mjd - 51544.5) / 36525.0
    gmst_s = (
        67310.54841
        + (876600.0 * 3600.0 + 8640184.812866) * Tu
        + 0.093104 * Tu**2
        - 6.2e-6 * Tu**3
    )
    return np.mod(gmst_s * TWOPI / 86400.0, TWOPI)


def gast(mjd_ut1, t_tt_cent):
    """Greenwich apparent sidereal time = GMST + equation of the
    equinoxes (dpsi cos(eps) + the two largest complementary terms of
    the IAU 2000 definition, ~0.9 mas total)."""
    eps0 = mean_obliquity(t_tt_cent)
    dpsi, deps = nutation_angles(t_tt_cent)
    _, _, _, _, Om = fundamental_args(t_tt_cent)
    ee_ct = (0.00264 * np.sin(Om) + 0.000063 * np.sin(2.0 * Om)) * ARCSEC
    return gmst82(mjd_ut1) + dpsi * np.cos(eps0 + deps) + ee_ct


# -- full chain -----------------------------------------------------------
def itrf_to_gcrs_matrix(mjd_ut1, t_tt_cent, xp_rad=0.0, yp_rad=0.0):
    """(..., 3, 3) matrix M with r_GCRS = M r_ITRF."""
    B = bias_matrix()
    P = precession_matrix(t_tt_cent)
    N = nutation_matrix(t_tt_cent)
    theta = gast(mjd_ut1, t_tt_cent)
    spin = _r3(-theta)
    W = _r1(-np.asarray(yp_rad, dtype=np.float64)) @ _r2(
        -np.asarray(xp_rad, dtype=np.float64)
    )
    # r_ITRF = W R3(GAST) N P B r_GCRS  ->  invert (all orthonormal)
    M_c2t = W @ _r3(theta) @ N @ P @ B
    return np.swapaxes(M_c2t, -1, -2)


def gcrs_posvel_from_itrf(
    itrf_m, mjd_ut1, t_tt_cent, xp_rad=0.0, yp_rad=0.0
):
    """Observatory GCRS position (m) and velocity (m/s).

    itrf_m: (3,) or (n, 3); mjd_ut1/t_tt_cent: scalar or (n,).
    Velocity = omega x r in the true-of-date frame (precession/nutation
    rates are ~1e-12 rad/s, 7 orders below Earth spin — neglected, as
    does the reference's velocity via finite differencing).
    """
    itrf = np.asarray(itrf_m, dtype=np.float64)
    M = itrf_to_gcrs_matrix(mjd_ut1, t_tt_cent, xp_rad, yp_rad)
    pos = (M @ itrf[..., None])[..., 0]
    omega = np.array([0.0, 0.0, OMEGA_EARTH])
    # v_GCRS = M (omega x r_ITRF) in the rotating-frame sense
    v_itrf = np.cross(np.broadcast_to(omega, itrf.shape), itrf)
    vel = (M @ v_itrf[..., None])[..., 0]
    return pos, vel


def itrf_to_geodetic(itrf_m):
    """WGS84 geodetic latitude (rad), longitude (rad), height (m)."""
    x, y, z = np.asarray(itrf_m, dtype=np.float64).T
    a, f = 6378137.0, 1.0 / 298.257223563
    b = a * (1 - f)
    e2 = f * (2 - f)
    p = np.hypot(x, y)
    lon = np.arctan2(y, x)
    # Bowring's method, one iteration (sub-mm for Earth surface)
    u = np.arctan2(z * a, p * b)
    ep2 = e2 / (1 - e2)
    lat = np.arctan2(
        z + ep2 * b * np.sin(u) ** 3, p - e2 * a * np.cos(u) ** 3
    )
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - N
    return lat, lon, h
