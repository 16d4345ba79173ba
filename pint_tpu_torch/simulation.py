"""Simulated barycentric pulsars, built by the port alone.

Counterpart of ``pint_tpu/simulation.py::make_test_pulsar`` for site-'@'
(barycentric TDB) data: TOAs uniform in MJD with frequencies and receiver
flags cycling, arrival times shifted until the port's own model phase is
integer, then white jitter from ``np.random.default_rng(seed)``.  The
host time arithmetic is the reference's (integer day + double-double
seconds, carried exactly), so both packages build the same TOAs.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import AU, C, SECS_PER_DAY
from pint_tpu_torch.models.builder import get_model
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
                     iterations: int = 3, orbit: bool = False, device=None):
    """Build (model, toas): the port's model from ``par`` and a TOA table
    of ``ntoa`` barycentric arrivals.

    ``orbit=True`` then puts the observatory on a synthetic circular 1-AU
    orbit in the x-y plane with a one-year period, phased from
    ``start_mjd``, exactly as the reference bench does after its
    simulation: the astrometric parameters get leverage, and the
    simulated phases do not include the orbit's Roemer delay.
    ``device`` is where the inversion's residual sweeps run."""
    rng = np.random.default_rng(seed)
    model = get_model(par)
    mjds = np.linspace(start_mjd, end_mjd, ntoa)
    freq = np.resize(np.asarray(freqs, dtype=np.float64), ntoa)
    err = np.full(ntoa, error_us)
    mjd_int = np.floor(mjds).astype(np.int64)
    sec = HostDD(mjds - mjd_int) * SECS_PER_DAY
    empty_flags = [dict() for _ in range(ntoa)]
    for _ in range(iterations):
        cm = model.compile(_table(mjd_int, sec, freq, err, empty_flags),
                           device=device, subtract_mean=False)
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
        ph = 2 * np.pi * (
            mjd_int + sec.to_float() / SECS_PER_DAY - start_mjd
        ) / 365.25
        pos = np.stack(
            [AU * np.cos(ph), AU * np.sin(ph), np.zeros_like(ph)], axis=-1
        )
        toas["ssb_obs_pos_ls"] = pos / C
    return model, toas
