"""Photon-event TOA loading from mission FITS files.

Counterpart of ``pint_tpu/event_toas.py`` (reference parity:
src/pint/event_toas.py / fermi_toas.py: load_event_TOAs,
load_Fermi_TOAs, the mission lookup tables): read an event table's TIME
column, convert mission elapsed time (MET) to MJD through
MJDREFI/MJDREFF/TIMEZERO, and build TOAs.

Supported event frames:
- barycentred events (TIMESYS='TDB', e.g. barycorr/axBary output): site
  '@', the full-precision path;
- events in UTC or TT at the geocentre (site '0'), or at a spacecraft
  registered through ``observatory.satellite.register_satellite``
  (``site=``).

Event TOAs get zero measurement uncertainty by convention (the
reference uses error=0 for photons), infinite frequency, and a
``photon`` flag; weights and energies ride in each TOA's flags, one
dict a photon, as the reference's do.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.io.fits import get_bintable
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs

# mission defaults (reference: event_toas mission lookup tables)
MISSIONS = {
    "nicer": dict(extname="EVENTS", timecol="TIME"),
    "nustar": dict(extname="EVENTS", timecol="TIME"),
    "xmm": dict(extname="EVENTS", timecol="TIME"),
    "rxte": dict(extname="EVENTS", timecol="TIME"),
    "swift": dict(extname="EVENTS", timecol="TIME"),
    "fermi": dict(extname="EVENTS", timecol="TIME"),
    "generic": dict(extname=None, timecol="TIME"),
}


def _mjdref(hdr) -> float:
    """The MET reference MJD of a FITS header (MJDREFI + MJDREFF, or
    MJDREF)."""
    if "MJDREFI" in hdr:
        return float(hdr["MJDREFI"]) + float(hdr.get("MJDREFF", 0.0))
    if "MJDREF" in hdr:
        return float(hdr["MJDREF"])
    raise PintTpuError("event file has no MJDREF/MJDREFI keyword")


def load_event_TOAs(
    path,
    mission: str = "generic",
    energy_range=None,
    errors_us: float = 0.0,
    weightcol: str = None,
    site: str = None,
    energycol: str = None,
) -> TOAs:
    """Event FITS -> TOAs (one per photon).

    weightcol: photon-weight column; weights ride in each TOA's flags
    (key 'weight') so they stay aligned through the time sort and any
    later subsetting.
    energycol: photon-energy column (e.g. Fermi 'ENERGY', MeV); stored
    in the 'energy' flag the same way — consumed by energy-dependent
    templates (templates/lceprimitives.py).
    site: observatory code override — pass the name registered via
    observatory.satellite.register_satellite to place the photons at
    the spacecraft (orbit-table geometry) instead of the defaults
    ('@' for barycentered TIMESYS=TDB files, '0' geocenter otherwise).
    """
    cfg = MISSIONS.get(mission.lower())
    if cfg is None:
        raise PintTpuError(
            f"unknown mission {mission!r}; known {sorted(MISSIONS)}"
        )
    hdu = get_bintable(path, cfg["extname"])
    hdr = hdu.header
    met = np.asarray(hdu.column(cfg["timecol"]), dtype=np.float64)
    weights = (
        np.asarray(hdu.column(weightcol), dtype=np.float64)
        if weightcol else None
    )
    energies = (
        np.asarray(hdu.column(energycol), dtype=np.float64)
        if energycol else None
    )
    if energy_range is not None and "PI" in [
        c.upper() for c in hdu.columns()
    ]:
        pi = np.asarray(hdu.column("PI"), dtype=np.float64)
        lo, hi = energy_range
        keep = (pi >= lo) & (pi <= hi)
        met = met[keep]
        if weights is not None:
            weights = weights[keep]
        if energies is not None:
            energies = energies[keep]
    mjdref = _mjdref(hdr)
    timezero = float(hdr.get("TIMEZERO", 0.0))
    timesys = str(hdr.get("TIMESYS", "TT")).upper()
    # exact split: integer reference day + (fractional day + MET) seconds
    ref_day = int(np.floor(mjdref))
    ref_sec = (mjdref - ref_day) * 86400.0
    sec = ref_sec + met + timezero

    if timesys == "TDB":
        default_site = "@"
        scale = "tdb"
    elif timesys in ("TT", "UTC"):
        default_site = "0"  # geocenter
        scale = timesys.lower()
    else:
        raise PintTpuError(f"unsupported event TIMESYS {timesys!r}")
    if site is not None and timesys == "TDB":
        raise PintTpuError(
            "site override is for unbarycentered events; this file is "
            "TIMESYS=TDB (already at the SSB)"
        )
    site = site if site is not None else default_site
    t = TimeArray(np.full(len(sec), ref_day, dtype=np.int64), 0.0, scale)
    t = t.add_seconds(sec)
    if scale == "tt":
        # TOAs store UTC for topocentric sites; convert once here
        t = t.to_scale("utc")
    n = len(sec)
    flags = [{"photon": "1", "mission": mission} for _ in range(n)]
    if weights is not None:
        for f, w in zip(flags, weights):
            f["weight"] = repr(float(w))
    if energies is not None:
        for f, e in zip(flags, energies):
            f["energy"] = repr(float(e))
    toas = TOAs(
        t,
        np.full(n, np.inf),  # photons: infinite frequency (no DM)
        np.full(n, errors_us),
        [site] * n,
        flags,
    )
    toas.sort()
    return toas


def get_event_weights(toas: TOAs):
    """Per-photon weights from the 'weight' flags, or None."""
    vals = toas.get_flag_value("weight", None)
    if any(v is None for v in vals):
        return None
    return np.array([float(v) for v in vals])


def get_event_energies(toas: TOAs):
    """Per-photon energies (MeV) from the 'energy' flags, or None."""
    vals = toas.get_flag_value("energy", None)
    if any(v is None for v in vals):
        return None
    return np.array([float(v) for v in vals])


def load_fermi_TOAs(path, **kw) -> TOAs:
    """Fermi photon events (reference: fermi_toas.load_Fermi_TOAs)."""
    return load_event_TOAs(path, mission="fermi", **kw)
