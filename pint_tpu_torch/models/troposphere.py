"""Tropospheric delay: hydrostatic and wet zenith delays through the
Niell (1996) mapping functions.

Counterpart of ``pint_tpu/models/troposphere.py::TroposphereDelay``: the
zenith hydrostatic delay of the standard-atmosphere pressure at the
observatory's altitude (Davis et al. 1985) and a nominal 0.1 m zenith wet
delay, each mapped to the source's elevation (seasonal hydrostatic
coefficients interpolated in latitude, ``ops/interp.py``).  The per-TOA
geometry rides in the bundle's masks like the other compile-time columns:

  TROPO:sin_elev  sine of the source elevation
  TROPO:lat       observatory geodetic latitude (rad)
  TROPO:alt       observatory altitude (m)
  TROPO:doy       day of year (the seasonal term)

taken from the table's ``masks`` (the reference's ingested geometry, or
a caller's), else from the geometry columns of the port's own ingest
(``obs_elevation_rad``, ``obs_lat_rad``, ``obs_alt_m``), else zeros: a
row without topocentric geometry (site '@') has no delay.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import boolParameter
from pint_tpu_torch.ops.interp import interp
from pint_tpu_torch.toas.bundle import table_mjd

# Niell 1996 hydrostatic mapping coefficients at |lat| = 15, 30, 45, 60, 75
_LAT_GRID = np.array([15.0, 30.0, 45.0, 60.0, 75.0]) * np.pi / 180.0
_HYD_AVG = np.array([
    [1.2769934e-3, 2.9153695e-3, 62.610505e-3],
    [1.2683230e-3, 2.9152299e-3, 62.837393e-3],
    [1.2465397e-3, 2.9288445e-3, 63.721774e-3],
    [1.2196049e-3, 2.9022565e-3, 63.824265e-3],
    [1.2045996e-3, 2.9024912e-3, 64.258455e-3],
])
_HYD_AMP = np.array([
    [0.0, 0.0, 0.0],
    [1.2709626e-5, 2.1414979e-5, 9.0128400e-5],
    [2.6523662e-5, 3.0160779e-5, 4.3497037e-5],
    [3.4000452e-5, 7.2562722e-5, 84.795348e-5],
    [4.1202191e-5, 11.723375e-5, 170.37206e-5],
])
_WET = np.array([
    [5.8021897e-4, 1.4275268e-3, 4.3472961e-2],
    [5.6794847e-4, 1.5138625e-3, 4.6729510e-2],
    [5.8118019e-4, 1.4572752e-3, 4.3908931e-2],
    [5.9727542e-4, 1.5007428e-3, 4.4626982e-2],
    [6.1641693e-4, 1.7599082e-3, 5.4736038e-2],
])
# height-correction coefficients (Niell 1996)
_A_HT, _B_HT, _C_HT = 2.53e-5, 5.49e-3, 1.14e-3

_C_M_S = 299792458.0
#: nominal zenith wet delay (m): the reference's fixed estimate
_ZWD_M = 0.1

MASK_KEYS = ("TROPO:sin_elev", "TROPO:lat", "TROPO:alt", "TROPO:doy")


def _herring(sin_e, a, b, c):
    """Herring continued-fraction mapping function."""
    top = 1.0 + a / (1.0 + b / (1.0 + c))
    bot = sin_e + a / (sin_e + b / (sin_e + c))
    return top / bot


def _interp_coeffs(table, lat):
    """Piecewise-linear latitude interpolation of a (5, 3) Niell table."""
    alat = torch.abs(lat)
    return [interp(alat, _LAT_GRID, table[:, j]) for j in range(3)]


class TroposphereDelay(DelayComponent):
    category = "troposphere"

    def __init__(self):
        super().__init__()
        self.add_param(boolParameter("CORRECT_TROPOSPHERE", value=True))

    def basis_keys(self) -> list[str]:
        return list(MASK_KEYS)

    def extra_masks(self, toas) -> dict:
        """The geometry columns of an ingested table (zeros without a
        source elevation: barycentric data, or no astrometry at ingest)."""
        elev = toas.get("obs_elevation_rad")
        if elev is None:
            n = len(toas["freq_mhz"])
            return {k: np.zeros(n) for k in MASK_KEYS}
        return {
            "TROPO:sin_elev": np.sin(elev),
            "TROPO:lat": np.asarray(toas["obs_lat_rad"]),
            "TROPO:alt": np.asarray(toas["obs_alt_m"]),
            # MJD 51544 = 2000-01-01; day-of-year mod 365.25 is plenty
            # for the ~1e-5 seasonal term
            "TROPO:doy": np.mod(table_mjd(toas) - 51544.0, 365.25),
        }

    @staticmethod
    def zenith_hydrostatic_m(lat, alt_m):
        """Davis et al. 1985 zenith delay from standard-atmosphere
        pressure."""
        p_hpa = 1013.25 * (1.0 - 2.2557e-5 * alt_m) ** 5.2568
        return 0.0022768 * p_hpa / (
            1.0 - 0.00266 * torch.cos(2.0 * lat) - 2.8e-7 * alt_m)

    def delay_term(self, pdict, bundle, acc_delay):
        if not self.params["CORRECT_TROPOSPHERE"].value:
            return torch.zeros_like(bundle.freq_mhz)
        sin_e, lat, alt, doy = (bundle.masks[k] for k in MASK_KEYS)
        valid = sin_e > 0.0
        s = torch.where(valid, sin_e, torch.ones_like(sin_e))
        # hydrostatic: seasonally varying coefficients
        a0, b0, c0 = _interp_coeffs(_HYD_AVG, lat)
        a1, b1, c1 = _interp_coeffs(_HYD_AMP, lat)
        # Niell's phase: DOY 28 in the north, half a year later in the south
        season = torch.cos(
            2.0 * math.pi * (doy - 28.0) / 365.25
            + torch.where(lat < 0, torch.full_like(lat, math.pi),
                          torch.zeros_like(lat)))
        mh = _herring(s, a0 - a1 * season, b0 - b1 * season,
                      c0 - c1 * season)
        # height correction
        mh = mh + (1.0 / s - _herring(s, _A_HT, _B_HT, _C_HT)) * (
            alt / 1000.0)
        aw, bw, cw = _interp_coeffs(_WET, lat)
        mw = _herring(s, aw, bw, cw)
        path_m = self.zenith_hydrostatic_m(lat, alt) * mh + _ZWD_M * mw
        return torch.where(valid, path_m / _C_M_S, torch.zeros_like(s))
