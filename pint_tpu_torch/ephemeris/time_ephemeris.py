"""TDB-TT as a numerical time ephemeris.

Two independent sources of TDB-TT exist in the framework:

1. the analytic Fairhead-Bretagnon series (``ops/tdb.py``), and
2. this module: direct numerical integration of the defining IAU 2006
   resolution B3 integral over a solar-system ephemeris,

       d(TDB-TT)/dt = (v_E^2/2 + U_ext(x_E))/c^2 - (L_B - L_G),

   where v_E is the barycentric velocity of the geocenter and U_ext the
   Newtonian potential of all solar-system bodies except Earth at the
   geocenter.  (The omitted c^-4 post-Newtonian terms contribute < 20 ns
   of annual periodic — part of the documented error budget.)

The two implementations share no code or coefficients, so their
agreement bounds the error of BOTH, an offline validation with no astropy/erfa
(PINT computes TDB in TOAs.compute_TDBs via astropy time scales).

The integral's mean rate and offset are calibrated away (L_B is
*defined* so TDB-TT has no secular drift; an analytic ephemeris's mean
integrand differs from the defining value at its own accuracy), leaving
the periodic part, which is what timing is sensitive to.

A Chebyshev-compressed product can be written as an SPK kernel with the
DE-t convention (target 1000000001 wrt center 1000000000, 1-component
type-2 segment holding TDB-TT in seconds), read back by
:class:`TimeEphemeris`, and installed as the global TT<->TDB provider
(:func:`install_time_ephemeris`) — the same override a real DE440t part
file provides for exact DE parity.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.ephemeris.spk import (
    SPK, S_PER_DAY, chebyshev_fit_records, write_spk_type2,
)

C_KM_S = 299792.458
# IAU defining constants
L_B = 1.550519768e-8
L_G = 6.969290134e-10
# GM (km^3/s^2) from the single source of truth in constants.py (DE440)
from pint_tpu_torch import constants as _const

GM = {
    "sun": _const.GM_SUN * 1e-9,
    "mercury": _const.GM_MERCURY * 1e-9,
    "venus": _const.GM_VENUS * 1e-9,
    "moon": _const.GM_MOON * 1e-9,
    "mars": _const.GM_MARS * 1e-9,
    "jupiter": _const.GM_JUPITER * 1e-9,
    "saturn": _const.GM_SATURN * 1e-9,
    "uranus": _const.GM_URANUS * 1e-9,
    "neptune": _const.GM_NEPTUNE * 1e-9,
}
TDB_TT_TARGET = 1000000001
TDB_TT_CENTER = 1000000000
# NAIF ids for SPK-backed ephemerides (SPK.ssb_posvel takes ints only;
# BuiltinEphemeris accepts either)
_NAIF = {
    "sun": 10, "mercury": 1, "venus": 2, "earth": 399, "moon": 301,
    "mars": 4, "jupiter": 5, "saturn": 6, "uranus": 7, "neptune": 8,
}


_builtin_fallback = None


def _builtin():
    global _builtin_fallback
    if _builtin_fallback is None:
        from pint_tpu_torch.ephemeris.builtin import BuiltinEphemeris

        _builtin_fallback = BuiltinEphemeris()
    return _builtin_fallback


def _posvel(ephem, body: str, et):
    """ssb_posvel accepting name-keyed bodies on both ephemeris kinds.

    A PERTURBING body absent from a partial SPK kernel falls back to
    the builtin analytic theory — its potential term needs only ~1e-4
    fractional accuracy.  'earth' and 'sun' get NO fallback: they set
    the dominant v^2/2 and GM_sun/r terms, and silently substituting
    the builtin there would defeat the point of supplying a DE kernel
    (the KeyError propagates instead)."""
    from pint_tpu_torch.ephemeris.spk import SPK

    if isinstance(ephem, SPK):
        # SPK kernels are NAIF-id keyed; skipping the name-keyed call
        # (rather than catching its TypeError) keeps genuine TypeError
        # bugs in name-keyed implementations visible
        pass
    else:
        try:
            return ephem.ssb_posvel(body, et)
        except KeyError:
            pass  # retry with the NAIF id
    try:
        return ephem.ssb_posvel(_NAIF[body], et)
    except KeyError:
        if body in ("earth", "sun"):
            raise
        return _builtin().ssb_posvel(body, et)


def _pos(ephem, body: str, et):
    """Position-only when the ephemeris offers it (skips the builtin's
    central-difference velocity — 3x fewer theory evaluations); same
    fallback policy as _posvel."""
    fn = getattr(ephem, "ssb_pos", None)
    if fn is not None:
        return fn(body, et)
    try:
        return ephem.ssb_posvel(_NAIF[body], et)[0]
    except KeyError:
        if body in ("earth", "sun"):
            raise
        return _builtin().ssb_pos(body, et)


def tdb_rate(ephem, et):
    """The periodic TDB-TT integrand (v^2/2 + U_ext)/c^2 - (L_B - L_G),
    dimensionless, at ET seconds past J2000; ``ephem`` provides
    ssb_posvel(body, et) -> (km, km/s) (BuiltinEphemeris or SPK-backed).
    """
    et = np.asarray(et, dtype=np.float64)
    epos, evel = _posvel(ephem, "earth", et)
    v2 = np.sum(np.square(evel), axis=-1)
    U = np.zeros_like(v2)
    for body, gm in GM.items():
        bpos = _pos(ephem, body, et)
        r = np.sqrt(np.sum(np.square(bpos - epos), axis=-1))
        U = U + gm / r
    return (0.5 * v2 + U) / C_KM_S**2 - (L_B - L_G)


def integrate_tdb_minus_tt(ephem, et0, et1, step_s=21600.0):
    """Cumulative-trapezoid TDB-TT over [et0, et1], linearly detrended.

    Returns (et_grid, tdb_minus_tt_periodic seconds).  The offset and
    residual mean rate are removed by least squares: the *defining*
    L_B makes the true TDB-TT drift-free, so any drift here measures the
    ephemeris's mean-integrand error, not a real signal.
    """
    n = int(np.ceil((et1 - et0) / step_s)) + 1
    et = et0 + np.arange(n) * step_s
    rate = tdb_rate(ephem, et)
    d = np.concatenate([
        [0.0], np.cumsum(0.5 * (rate[1:] + rate[:-1])) * step_s
    ])
    # detrend: subtract LSQ offset + slope
    t = (et - et.mean()) / (et1 - et0)
    A = np.stack([np.ones_like(t), t], axis=-1)
    coef, *_ = np.linalg.lstsq(A, d, rcond=None)
    return et, d - A @ coef


class TimeEphemeris:
    """TDB-TT evaluated from an SPK time-ephemeris segment (DE-t
    convention: 1-component Chebyshev, seconds; reference capability:
    astropy's ephemeris time scales over de430t/de440t part files)."""

    def __init__(self, spk: SPK):
        segs = spk.pairs.get((TDB_TT_TARGET, TDB_TT_CENTER))
        if not segs:
            raise KeyError(
                f"no TDB-TT segment ({TDB_TT_TARGET} <- {TDB_TT_CENTER}) "
                f"in {spk.name}; pairs: {sorted(spk.pairs)}"
            )
        self.spk = spk
        self.segments = segs

    @classmethod
    def open(cls, path) -> "TimeEphemeris":
        return cls(SPK.open(path))

    def tdb_minus_tt(self, et):
        """TDB-TT (s) at ET seconds past J2000 (TDB argument; the
        ~1.7 ms argument difference from TT shifts the annual term by
        ~3e-13 s)."""
        pos, _vel = self.spk._eval_pair(self.segments, np.asarray(et))
        return pos[..., 0]  # 1-component segment: TDB-TT seconds


def build_time_ephemeris_spk(
    path, ephem, mjd0: float, mjd1: float,
    days_per_record: float = 32.0, degree: int = 10,
    step_s: float = 21600.0,
):
    """Integrate TDB-TT over [mjd0, mjd1] (TT MJD) with ``ephem`` and
    write it as a DE-t-convention SPK at ``path``.

    Chebyshev fit error is < 1 ns at (32 d, degree 10); total accuracy
    is set by the ephemeris driving the integral (docs/precision.md)."""
    et0 = (mjd0 - 51544.5) * S_PER_DAY
    et1 = (mjd1 - 51544.5) * S_PER_DAY
    # integrate on a fine grid, then interpolate onto Chebyshev nodes
    pad = 10 * step_s
    et, d = integrate_tdb_minus_tt(ephem, et0 - pad, et1 + pad, step_s)

    def fn(ts):
        # cubic-quality interpolation via local polynomial is overkill:
        # the 6 h grid resolves the fastest significant term (~27.3 d)
        # to < 0.1 ns with cubic; np.interp (linear) would lose ~2 ns,
        # so use a piecewise cubic through 4 nearest samples.
        ts = np.asarray(ts)
        idx = np.clip(
            np.searchsorted(et, ts) - 1, 1, len(et) - 3
        )
        out = np.zeros_like(ts)
        for k in range(-1, 3):
            # Lagrange basis over the 4-point stencil
            lk = np.ones_like(ts)
            xk = et[idx + k]
            for j in range(-1, 3):
                if j != k:
                    xj = et[idx + j]
                    lk = lk * (ts - xj) / (xk - xj)
            out = out + lk * d[idx + k]
        return out[..., None]  # 1-component (DE-t convention)

    n_records = int(np.ceil((mjd1 - mjd0) / days_per_record))
    intlen = (et1 - et0) / n_records
    coeffs = chebyshev_fit_records(
        fn, et0, et1, n_records, degree, ncomp=1
    )
    write_spk_type2(path, [{
        "target": TDB_TT_TARGET, "center": TDB_TT_CENTER,
        "frame": 1, "init": et0, "intlen": intlen, "coeffs": coeffs,
    }], ifname="pint_tpu TDB-TT time ephemeris")
    return path


def install_time_ephemeris(te: "TimeEphemeris | None"):
    """Install (or clear, with None) the global TDB-TT provider used by
    timebase conversions in place of the analytic series."""
    from pint_tpu_torch.timebase import tdb as tdb_mod

    if te is None:
        tdb_mod._time_ephemeris_fn = None
    else:
        def fn(et):
            return te.tdb_minus_tt(et)

        tdb_mod._time_ephemeris_fn = fn
