"""Satellite observatories: spacecraft position from orbit files.

Counterpart of ``pint_tpu/observatory/satellite.py``: photon TOAs
recorded at a spacecraft need the spacecraft's GCRS position at each
event; orbit products (Fermi FT2, NICER .orb, generic tables) supply a
time series that is spline-interpolated to the TOA epochs.

Supported orbit tables (FITS BINTABLE via ``io/fits.py``):
- Fermi FT2 style: START/STOP (MET s) + SC_POSITION (3-vector, m)
- generic:         TIME (MET s) + X/Y/Z columns (m) [or POSITION]
The MET epoch comes from MJDREFI/MJDREFF (+TIMEZERO), like event files.
Positions are taken as inertial J2000 (GCRS to the accuracy class of
the products themselves).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.observatory import Observatory, register_observatory


def mjdref_of(hdr) -> float:
    """The MET reference MJD of a FITS header (MJDREFI + MJDREFF, or
    MJDREF)."""
    if "MJDREFI" in hdr:
        return float(hdr["MJDREFI"]) + float(hdr.get("MJDREFF", 0.0))
    if "MJDREF" in hdr:
        return float(hdr["MJDREF"])
    raise PintTpuError("event file has no MJDREF/MJDREFI keyword")


class SatelliteObs(Observatory):
    """Spacecraft location interpolated from an orbit product."""

    def __init__(self, name, mjd_tt, pos_m, aliases=()):
        super().__init__(name, aliases)
        order = np.argsort(mjd_tt)
        self.mjd_tt = np.asarray(mjd_tt, dtype=np.float64)[order]
        self.pos_m = np.asarray(pos_m, dtype=np.float64)[order]
        if len(self.mjd_tt) < 4:
            raise PintTpuError(
                f"orbit table for {name!r} has {len(self.mjd_tt)} rows; "
                "need >= 4 for spline interpolation"
            )
        from scipy.interpolate import CubicSpline

        self._spline = CubicSpline(self.mjd_tt, self.pos_m, axis=0)

    @property
    def is_satellite(self):
        return True

    def earth_location_itrf(self):
        return None  # not an Earth-fixed site

    def posvel_gcrs(self, mjd_tt):
        """Interpolated GCRS position (m) and velocity (m/s)."""
        mjd = np.asarray(mjd_tt, dtype=np.float64)
        lo, hi = self.mjd_tt[0], self.mjd_tt[-1]
        bad = (mjd < lo - 1e-8) | (mjd > hi + 1e-8)
        if np.any(bad):
            raise PintTpuError(
                f"{int(bad.sum())} TOAs outside the orbit table span "
                f"[{lo:.6f}, {hi:.6f}] MJD(TT) for {self.name!r}"
            )
        pos = self._spline(mjd)
        vel = self._spline(mjd, 1) / 86400.0  # per-day -> per-second
        return pos, vel

    @classmethod
    def from_orbit_file(cls, name, path, aliases=()) -> "SatelliteObs":
        from pint_tpu_torch.io.fits import read_fits

        hdu = None
        for h in read_fits(path):
            if h.is_bintable() and h.name.upper() in (
                "SC_DATA", "ORBIT", "PREFILTER", "EVENTS", "",
            ):
                hdu = h
                break
            if h.is_bintable() and hdu is None:
                hdu = h
        if hdu is None:
            raise PintTpuError(f"no orbit table found in {path}")
        cols = {c.upper() for c in hdu.columns()}
        hdr = hdu.header
        mjdref = mjdref_of(hdr)  # raises clearly when MJDREF* is absent
        tz = float(hdr.get("TIMEZERO", 0.0))
        if "START" in cols:
            met = np.asarray(hdu.column("START"), dtype=np.float64)
        elif "TIME" in cols:
            met = np.asarray(hdu.column("TIME"), dtype=np.float64)
        else:
            raise PintTpuError(f"orbit table {path}: no TIME/START column")
        if "SC_POSITION" in cols:
            pos = np.asarray(
                hdu.column("SC_POSITION"), dtype=np.float64
            )
        elif {"X", "Y", "Z"} <= cols:
            pos = np.stack(
                [np.asarray(hdu.column(c), dtype=np.float64)
                 for c in ("X", "Y", "Z")], axis=-1,
            )
        else:
            raise PintTpuError(
                f"orbit table {path}: no SC_POSITION or X/Y/Z columns"
            )
        # TIMESYS of orbit products is TT for the missions we cover
        mjd_tt = mjdref + (met + tz) / 86400.0
        return cls(name, mjd_tt, pos, aliases=aliases)


def register_satellite(name, orbit_path, aliases=()) -> SatelliteObs:
    """Load an orbit product and register the spacecraft as an
    observatory usable in TOA site columns."""
    sat = SatelliteObs.from_orbit_file(name, orbit_path, aliases=aliases)
    register_observatory(sat)
    return sat
