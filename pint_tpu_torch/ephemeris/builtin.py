"""Built-in analytic solar-system ephemeris (no kernel file needed).

The Earth family (earth/moon/emb) comes from the truncated VSOP87
theory (ephemeris/vsop87.py, ~0.2 arcsec for the geocenter) plus a
truncated lunar theory (Meeus ch.47 main terms, ~30 km for the Moon ->
~0.4 km for the EMB offset), both rotated from the ecliptic of date to
equatorial J2000 via the IAU1976 precession chain.  The planets use
Keplerian mean elements + rates (Standish & Williams, "Approximate
Positions of the Major Planets", valid 1800-2050, ~10-20 arcsec), and
the Sun-SSB barycenter offset is the mass-ratio-weighted sum over the
Kepler planets.

ACCURACY (documented, by design): the geocenter is arcsecond-class
(~150-700 km; dominated by VSOP87 truncation + the Kepler-grade Sun
wobble), the planets ~10-20 arcsec.  That is ample for SIMULATION,
internal round-trip consistency (fits of simulated data use the same
ephemeris and agree to sub-ns), Shapiro-delay geometry (angle errors
only), and for driving the TDB-TT defining integral to ~0.1 us
(ephemeris/time_ephemeris.py) — but NOT for absolute timing parity
with DExxx-based packages; supply a real .bsp kernel
(``ephemeris/spk.py``) for that; the reference has the same split
via jplephem + astropy's 'builtin' ephemeris.
"""

from __future__ import annotations

import numpy as np

AU_KM = 149597870.7
S_PER_DAY = 86400.0
_EMRAT = 81.30056907419062  # Earth/Moon mass ratio (DE430 value)
_OBL = np.deg2rad(84381.448 / 3600.0)  # J2000 mean obliquity

# (a AU, e, I deg, L deg, varpi deg, Omega deg) + per-century rates
_ELEMENTS = {
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350,
                 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                 0.16047689, -0.12534081)),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950,
               131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729,
               0.00268329, -0.27769418)),
    "emb": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
             102.93768193, 0.0),
            (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
             0.32327364, 0.0)),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205,
              -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499,
              0.44441088, -0.29257343)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.00508664)),
}

# planet/Sun mass ratios (IAU/DE430); used for the SSB offset
_MASS_RATIO = {
    "mercury": 1.0 / 6023600.0,
    "venus": 1.0 / 408523.71,
    "emb": 1.0 / 328900.56,
    "mars": 1.0 / 3098708.0,
    "jupiter": 1.0 / 1047.3486,
    "saturn": 1.0 / 3497.898,
    "uranus": 1.0 / 22902.98,
    "neptune": 1.0 / 19412.24,
}


def _kepler_xyz(name, t_cent):
    """Heliocentric ecliptic-J2000 position (AU), vectorized."""
    el0, rate = _ELEMENTS[name]
    T = np.asarray(t_cent, dtype=np.float64)
    a = el0[0] + rate[0] * T
    e = el0[1] + rate[1] * T
    inc = np.deg2rad(el0[2] + rate[2] * T)
    L = np.deg2rad(el0[3] + rate[3] * T)
    varpi = np.deg2rad(el0[4] + rate[4] * T)
    Om = np.deg2rad(el0[5] + rate[5] * T)
    om = varpi - Om
    M = np.mod(L - varpi + np.pi, 2 * np.pi) - np.pi
    E = M + e * np.sin(M)
    for _ in range(8):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)
    co, so = np.cos(om), np.sin(om)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    x = (co * cO - so * sO * ci) * xp + (-so * cO - co * sO * ci) * yp
    y = (co * sO + so * cO * ci) * xp + (-so * sO + co * cO * ci) * yp
    z = (so * si) * xp + (co * si) * yp
    return np.stack([x, y, z], axis=-1)


def _moon_geocentric_km(t_cent):
    """Geocentric Moon, ecliptic + mean equinox OF DATE (km); truncated
    ELP (Meeus ch.47 main terms, ~0.01 deg / ~30 km — the EMB offset
    error this induces is ~0.4 km).  Callers must rotate to J2000 via
    vsop87._ecl_of_date_to_eq_j2000 (see _pos_eq_au)."""
    T = np.asarray(t_cent, dtype=np.float64)
    d2r = np.deg2rad
    Lp = d2r(218.3164477 + 481267.88123421 * T)
    D = d2r(297.8501921 + 445267.1114034 * T)
    M = d2r(357.5291092 + 35999.0502909 * T)
    Mp = d2r(134.9633964 + 477198.8675055 * T)
    F = d2r(93.2720950 + 483202.0175233 * T)
    lon = Lp + d2r(
        6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
        + 0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp)
        - 0.185116 * np.sin(M) - 0.114332 * np.sin(2 * F)
    )
    lat = d2r(
        5.128122 * np.sin(F) + 0.280602 * np.sin(Mp + F)
        + 0.277693 * np.sin(Mp - F)
    )
    r = (
        385000.56 - 20905.355 * np.cos(Mp)
        - 3699.111 * np.cos(2 * D - Mp) - 2955.968 * np.cos(2 * D)
    )
    cl, sl = np.cos(lon), np.sin(lon)
    cb, sb = np.cos(lat), np.sin(lat)
    return np.stack([r * cb * cl, r * cb * sl, r * sb], axis=-1)


def _ecl_to_eq(xyz):
    """Ecliptic J2000 -> equatorial J2000 (ICRS to ~0.02")."""
    c, s = np.cos(_OBL), np.sin(_OBL)
    x, y, z = np.moveaxis(np.asarray(xyz), -1, 0)
    return np.stack([x, c * y - s * z, s * y + c * z], axis=-1)


class BuiltinEphemeris:
    """Analytic ephemeris with the SPK-style ssb_posvel interface
    (km, km/s; NAIF ids and lowercase names accepted)."""

    name = "builtin"
    _IDS = {
        10: "sun", 399: "earth", 3: "emb", 301: "moon",
        1: "mercury", 199: "mercury", 2: "venus", 299: "venus",
        4: "mars", 499: "mars", 5: "jupiter", 599: "jupiter",
        6: "saturn", 699: "saturn", 7: "uranus", 799: "uranus",
        8: "neptune", 899: "neptune",
    }

    def _sun_ssb_au(self, t_cent):
        """Sun wrt SSB (AU, ecliptic): -sum(m_i r_i)/(1 + sum m_i).

        Memoized on the epoch array: every body evaluation routes
        through the Sun wobble, so the TDB-integrand's 9-body potential
        loop (time_ephemeris.tdb_rate) would otherwise redo the 8
        Kepler solves per body on the same grid.  A small KEYED dict
        (not a single slot): the chunked parallel ingest evaluates
        several epoch grids concurrently, and a last-value slot
        thrashes across chunks.
        Plain dict ops are atomic under the GIL; a lost duplicate
        insert is a benign recompute, never a wrong value."""
        t_cent = np.asarray(t_cent, dtype=np.float64)
        key = (t_cent.shape, t_cent.tobytes())
        memo = getattr(self, "_sun_memo_map", None)
        if memo is None:
            memo = self._sun_memo_map = {}
        cached = memo.get(key)
        if cached is not None:
            return cached
        num = 0.0
        msum = 0.0
        for nm, mr in _MASS_RATIO.items():
            num = num + mr * _kepler_xyz(nm, t_cent)
            msum += mr
        out = -num / (1.0 + msum)
        if len(memo) >= 32:  # one entry per live chunk grid, bounded
            memo.clear()
        memo[key] = out
        return out

    def _pos_au_ecl(self, body, t_cent):
        if body == "sun":
            return self._sun_ssb_au(t_cent)
        return self._sun_ssb_au(t_cent) + _kepler_xyz(body, t_cent)

    def _pos_eq_au(self, body, t_cent):
        """SSB-centric equatorial J2000 position (AU)."""
        if body in ("earth", "moon", "emb"):
            from pint_tpu_torch.ephemeris import vsop87

            sun = _ecl_to_eq(self._sun_ssb_au(t_cent))
            earth = sun + vsop87.earth_heliocentric_j2000(
                np.asarray(t_cent, dtype=np.float64) / 10.0
            )
            if body == "earth":
                return earth
            # Meeus lunar theory is ecliptic+equinox OF DATE
            moon_geo = vsop87._ecl_of_date_to_eq_j2000(
                _moon_geocentric_km(t_cent) / AU_KM, t_cent
            )
            if body == "moon":
                return earth + moon_geo
            return earth + moon_geo / (1.0 + _EMRAT)  # emb
        return _ecl_to_eq(self._pos_au_ecl(body, t_cent))

    def ssb_pos(self, body, et):
        """Position-only ssb_posvel (km): skips the central-difference
        velocity (3x fewer theory evaluations — the TDB integrand's
        potential loop only needs positions)."""
        if isinstance(body, (int, np.integer)):
            body = self._IDS[int(body)]
        et = np.asarray(et, dtype=np.float64)
        return self._pos_eq_au(
            body.lower(), et / (36525.0 * S_PER_DAY)
        ) * AU_KM

    def ssb_posvel(self, body, et):
        """SSB-centric equatorial-J2000 position (km) and velocity
        (km/s) at ET seconds past J2000 (TDB); velocity by central
        difference (60 s), consistent with the position model."""
        if isinstance(body, (int, np.integer)):
            body = self._IDS[int(body)]
        body = body.lower()
        et = np.asarray(et, dtype=np.float64)
        t_cent = et / (36525.0 * S_PER_DAY)
        pos = self._pos_eq_au(body, t_cent) * AU_KM
        h = 60.0
        tp = (et + h) / (36525.0 * S_PER_DAY)
        tm = (et - h) / (36525.0 * S_PER_DAY)
        vel = (
            self._pos_eq_au(body, tp) - self._pos_eq_au(body, tm)
        ) * AU_KM / (2.0 * h)
        return pos, vel
