"""Simulated barycentric pulsars, built by the port alone.

Counterpart of ``pint_tpu/simulation.py::make_test_pulsar`` for site-'@'
(barycentric TDB) data: TOAs uniform in MJD with frequencies and receiver
flags cycling, arrival times shifted until the port's own model phase is
integer, then white jitter from ``np.random.default_rng(seed)``.  The
host time arithmetic is the reference's (integer day + double-double
seconds, carried exactly), so both packages build the same TOAs.

:func:`msp_par` writes the par text of the binary millisecond pulsar that
``chip_smoke.py`` and the tests drive: a NANOGrav-class ELL1 MSP modelled
on J1909-3744, with DMX ranges, FD, a JUMP and red noise.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import AU, C, SECS_PER_DAY
from pint_tpu_torch.models.builder import get_model

#: the binary MSP's observing frequencies (MHz), cycled over the TOAs
#: while the receiver flags cycle over (L-wide, S-wide): every frequency
#: meets both receivers, so FD, JUMP and DMX are not degenerate
MSP_FREQS = (820.0, 1150.0, 1400.0, 1700.0, 2300.0)
#: the span the DMX ranges cover (MJD), that of the simulations
MSP_SPAN = (53000.0, 57500.0)


def msp_par(ndmx: int = 150, seed: int = 0) -> str:
    """Par text of the binary MSP: ecliptic astrometry with proper motion
    and parallax, F0/F1, DM frozen with ``ndmx`` DMX ranges covering MJD
    52999.5-57500.5 (150 ranges are ~30-day epochs; values from
    ``default_rng(seed)``, N(0, 1e-3) pc cm^-3), FD1/FD2, a JUMP on
    S-wide, an ELL1 orbit with Shapiro (M2, SINI), EFAC/EQUAD on both
    receivers and 30-harmonic power-law red noise.  Free: 5 astrometric,
    2 spin, ndmx DMX, 2 FD, 1 JUMP and 7 binary parameters (167 at 150
    ranges; 168 design columns with the offset)."""
    rng = np.random.default_rng(seed)
    dmx = rng.normal(0.0, 1e-3, ndmx)
    edges = np.linspace(MSP_SPAN[0] - 0.5, MSP_SPAN[1] + 0.5, ndmx + 1)
    lines = [
        "PSR J1909-3744SIM", "ELONG 284.2109 1", "ELAT -15.1555 1",
        "PMELONG -13.869 1", "PMELAT -34.021 1", "PX 0.861 1",
        "POSEPOCH 55000", "F0 339.31568732647 1", "F1 -1.6148e-15 1",
        "PEPOCH 55000", "DM 10.3931",
    ]
    for i in range(ndmx):
        lines += [f"DMX_{i + 1:04d} {dmx[i]:.9e} 1",
                  f"DMXR1_{i + 1:04d} {edges[i]:.4f}",
                  f"DMXR2_{i + 1:04d} {edges[i + 1]:.4f}"]
    lines += [
        "FD1 1.2e-5 1", "FD2 -4.3e-6 1", "JUMP -f S-wide 2.1e-6 1",
        "BINARY ELL1", "PB 1.533449474406 1", "A1 1.89799106 1",
        "TASC 53113.9505874 1", "EPS1 2.3e-8 1", "EPS2 -9.9e-8 1",
        "M2 0.2 1", "SINI 0.998 1",
        "EFAC -f L-wide 1.1", "EFAC -f S-wide 1.05",
        "EQUAD -f L-wide 0.5", "EQUAD -f S-wide 0.3",
        "TNREDAMP -13.5", "TNREDGAM 3.7", "TNREDC 30",
    ]
    return "\n".join(lines) + "\n"
from pint_tpu_torch.timebase.hostdd import HostDD, carry_days


def _table(mjd_int, sec: HostDD, freq, error_us, flags) -> dict:
    n = len(freq)
    return {
        "tdb_day": mjd_int.astype(np.float64),
        "tdb_sec_hi": np.array(sec.hi, dtype=np.float64),
        "tdb_sec_lo": np.array(sec.lo, dtype=np.float64),
        "freq_mhz": np.asarray(freq, dtype=np.float64),
        "error_us": np.asarray(error_us, dtype=np.float64),
        "pulse_number": np.full(n, np.nan),
        "padd": np.zeros(n),
        "flags": flags,
    }


def make_test_pulsar(par: str, ntoa: int = 64, start_mjd: float = 54000.0,
                     end_mjd: float = 56000.0, seed: int = 0,
                     jitter_us: float = 1.0, freqs=(1400.0, 800.0),
                     flags=("L-wide", "S-wide"), error_us: float = 1.0,
                     iterations: int = 3, orbit: bool = False,
                     orbit_in_phase: bool = False, device=None):
    """Build (model, toas): the port's model from ``par`` and a TOA table
    of ``ntoa`` barycentric arrivals.

    ``orbit=True`` then puts the observatory on a synthetic circular 1-AU
    orbit in the x-y plane with a one-year period, phased from
    ``start_mjd``, exactly as the reference bench does after its
    simulation: the astrometric parameters get leverage, and the
    simulated phases do not include the orbit's Roemer delay.  With
    ``orbit_in_phase=True`` as well, the orbit is in place during the
    inversion, so the simulated arrivals include its delays and the
    model at its par values fits them to the white noise.
    ``device`` is where the inversion's residual sweeps run."""
    rng = np.random.default_rng(seed)
    model = get_model(par)
    mjds = np.linspace(start_mjd, end_mjd, ntoa)
    freq = np.resize(np.asarray(freqs, dtype=np.float64), ntoa)
    err = np.full(ntoa, error_us)
    mjd_int = np.floor(mjds).astype(np.int64)
    sec = HostDD(mjds - mjd_int) * SECS_PER_DAY
    empty_flags = [dict() for _ in range(ntoa)]

    def orbit_pos(mjd_int, sec):
        ph = 2 * np.pi * (
            mjd_int + sec.to_float() / SECS_PER_DAY - start_mjd
        ) / 365.25
        pos = np.stack(
            [AU * np.cos(ph), AU * np.sin(ph), np.zeros_like(ph)], axis=-1
        )
        return pos / C

    for _ in range(iterations):
        table = _table(mjd_int, sec, freq, err, empty_flags)
        if orbit and orbit_in_phase:
            table["ssb_obs_pos_ls"] = orbit_pos(mjd_int, sec)
        cm = model.compile(table, device=device, subtract_mean=False)
        cm.track_mode = "nearest"
        resid = cm.time_residuals(cm.x0(), subtract_mean=False)
        mjd_int, sec = carry_days(mjd_int, sec + (-resid.cpu().numpy()))
    toa_flags = [{"f": flags[i % len(flags)]} for i in range(ntoa)]
    if jitter_us:
        mjd_int, sec = carry_days(
            mjd_int, sec + rng.normal(0.0, jitter_us * 1e-6, ntoa)
        )
    toas = _table(mjd_int, sec, freq, err, toa_flags)
    if orbit:
        toas["ssb_obs_pos_ls"] = orbit_pos(mjd_int, sec)
    return model, toas
