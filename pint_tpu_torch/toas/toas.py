"""TOAs container: the host-side table of arrival times + metadata.

Counterpart of ``pint_tpu/toas/toas.py::TOAs``: plain numpy arrays and a
``TimeArray`` of arrival times, with the ingest pipeline
(``toas/ingest.py``) filling the computed columns.  :meth:`TOAs.table`
gives the host TOA table (``toas/bundle.py``) that ``TimingModel.compile``
and ``make_bundle`` move to the device, in the bundle's units.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_tpu_torch.constants import C
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray


class TOAs:
    """Table of TOAs.

    Core columns (always present):
      t         TimeArray (UTC at observatory, unless site '@'/bary)
      freq      observing frequency, MHz (np.inf for infinite-frequency)
      error_us  TOA uncertainty in microseconds
      obs       observatory codes (list[str])
      flags     list[dict] per-TOA tim flags
    Computed columns (after ingest):
      clock_corr_s   applied clock correction (seconds)
      t_tdb          TimeArray in TDB at the observatory (time scale only)
      ssb_obs_pos/vel   m, m/s GCRS->SSB observatory state (n,3)
      obs_sun_pos       m, obs->Sun vector (n,3)
      obs_planet_pos    dict body -> (n,3) m
    """

    def __init__(self, t: TimeArray, freq, error_us, obs, flags=None):
        n = len(t)
        self.t = t
        self.freq = np.asarray(freq, dtype=np.float64)
        self.error_us = np.asarray(error_us, dtype=np.float64)
        self.obs = list(obs)
        self.flags = flags if flags is not None else [dict() for _ in range(n)]
        assert len(self.freq) == n and len(self.error_us) == n
        assert len(self.obs) == n and len(self.flags) == n
        # computed columns
        self.clock_corr_s: Optional[np.ndarray] = None
        self.t_tdb: Optional[TimeArray] = None
        self.ssb_obs_pos: Optional[np.ndarray] = None
        self.ssb_obs_vel: Optional[np.ndarray] = None
        self.obs_sun_pos: Optional[np.ndarray] = None
        self.obs_planet_pos: dict = {}
        self.obs_lat_rad: Optional[np.ndarray] = None
        self.obs_alt_m: Optional[np.ndarray] = None
        self.obs_elevation_rad: Optional[np.ndarray] = None
        self.ephem: Optional[str] = None
        self.clock_info: dict = {}

    # per-TOA computed columns that slice/sort alongside the core ones
    _COMPUTED_COLS = (
        "clock_corr_s", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
        "obs_lat_rad", "obs_alt_m", "obs_elevation_rad",
    )

    # ------------------------------------------------------------------ #
    def __len__(self):
        return len(self.t)

    def __getitem__(self, idx) -> "TOAs":
        if isinstance(idx, (int, np.integer)):
            idx = slice(idx, idx + 1)
        sel = np.arange(len(self))[idx]
        out = TOAs(
            self.t[sel],
            self.freq[sel],
            self.error_us[sel],
            [self.obs[i] for i in sel],
            [self.flags[i] for i in sel],
        )
        for col in self._COMPUTED_COLS:
            v = getattr(self, col)
            if v is not None:
                setattr(out, col, v[sel])
        if self.t_tdb is not None:
            out.t_tdb = self.t_tdb[sel]
        out.obs_planet_pos = {k: v[sel] for k, v in self.obs_planet_pos.items()}
        out.ephem = self.ephem
        return out

    def mjd_float(self) -> np.ndarray:
        return self.t.mjd_float()

    def sort(self) -> np.ndarray:
        """Sort in place by time; returns the permutation applied."""
        order = self.t.sort_index()
        self.t = self.t[order]
        self.freq = self.freq[order]
        self.error_us = self.error_us[order]
        self.obs = [self.obs[i] for i in order]
        self.flags = [self.flags[i] for i in order]
        for col in self._COMPUTED_COLS:
            v = getattr(self, col)
            if v is not None:
                setattr(self, col, v[order])
        if self.t_tdb is not None:
            self.t_tdb = self.t_tdb[order]
        self.obs_planet_pos = {
            k: v[order] for k, v in self.obs_planet_pos.items()
        }
        return order

    def get_flag_value(self, flag: str, default="") -> list:
        return [f.get(flag, default) for f in self.flags]

    def is_wideband(self) -> bool:
        """True when every TOA carries a wideband DM measurement
        (-pp_dm flag; reference: toa.py::TOAs.is_wideband)."""
        return len(self) > 0 and all("pp_dm" in f for f in self.flags)

    def get_dm_measurements(self) -> tuple[np.ndarray, np.ndarray]:
        """Wideband DM measurements + errors (pc/cm^3) from -pp_dm /
        -pp_dme flags; NaN where absent."""
        dm = np.array(
            [float(f.get("pp_dm", np.nan)) for f in self.flags]
        )
        dme = np.array(
            [float(f.get("pp_dme", np.nan)) for f in self.flags]
        )
        return dm, dme

    def get_pulse_numbers(self) -> Optional[np.ndarray]:
        """Per-TOA pulse numbers from -pn flags, if all present."""
        pns = self.get_flag_value("pn", None)
        if any(p is None for p in pns):
            return None
        return np.array([float(p) for p in pns])

    @property
    def ntoas(self):
        return len(self)

    def first_mjd(self) -> float:
        return float(np.min(self.mjd_float()))

    def last_mjd(self) -> float:
        return float(np.max(self.mjd_float()))

    def table(self) -> dict:
        """The host TOA table of the ingested TOAs, in the bundle's units
        (``toas/bundle.py``): TDB epochs as day + double-double seconds,
        geometry in light-seconds and v/c (zeros where a column is
        unset, as for barycentric data), pulse numbers from ``-pn`` flags
        (NaN when any TOA lacks one), phase adds from ``-padd`` flags,
        the flags and sites, the arrival MJDs (``mjd_float``: the range
        selections of DMX, SWX, ECORR and mask parameters, as the
        reference reads them), and the troposphere's geometry."""
        if self.t_tdb is None:
            raise ValueError(
                "TOAs not ingested: run toas/ingest.py's ingest first "
                "(or ingest_barycentric for site '@' data)"
            )
        n = len(self)
        zeros3 = np.zeros((n, 3))

        def geom(v):
            return (zeros3 if v is None else v) / C

        pn = self.get_pulse_numbers()
        out = {
            "tdb_day": np.asarray(self.t_tdb.mjd_int, dtype=np.float64),
            "tdb_sec_hi": self.t_tdb.sec.hi,
            "tdb_sec_lo": self.t_tdb.sec.lo,
            "freq_mhz": self.freq,
            "error_us": self.error_us,
            "ssb_obs_pos_ls": geom(self.ssb_obs_pos),
            "ssb_obs_vel_c": geom(self.ssb_obs_vel),
            "obs_sun_pos_ls": geom(self.obs_sun_pos),
            "obs_planet_pos_ls": {
                k: v / C for k, v in self.obs_planet_pos.items()},
            "pulse_number": np.full(n, np.nan) if pn is None else pn,
            "padd": np.array([float(f.get("padd", 0.0))
                              for f in self.flags], dtype=np.float64),
            "flags": self.flags,
            "obs": self.obs,
            "mjd_float": self.mjd_float(),
        }
        for col in ("obs_lat_rad", "obs_alt_m", "obs_elevation_rad"):
            if getattr(self, col) is not None:
                out[col] = getattr(self, col)
        return out

    def __repr__(self):
        return (
            f"TOAs(n={len(self)}, mjd {self.first_mjd():.1f}-"
            f"{self.last_mjd():.1f}, obs {sorted(set(self.obs))})"
        )


def merge_TOAs(toas_list) -> TOAs:
    """Concatenate TOA sets (reference: toa.merge_TOAs).  Computed
    columns merge only when present on every member (else they reset to
    None and a re-ingest is needed); the result is time-sorted.
    Members ingested with different ephemerides refuse to merge (their
    geometry columns would be inconsistent)."""
    if not toas_list:
        raise ValueError("nothing to merge")
    t0 = toas_list[0]
    # geometry consistency: members whose SSB geometry columns are
    # populated must agree on the ephemeris that produced them —
    # including ephem=None members (barycentric ingest), whose columns
    # would otherwise silently concatenate under another member's tag
    geom_ephems = {t.ephem for t in toas_list if t.ssb_obs_pos is not None}
    if len(geom_ephems) > 1:
        raise ValueError(
            "cannot merge TOAs with geometry computed under different "
            f"ephemerides: {sorted(str(e) for e in geom_ephems)}"
        )
    ephems = {t.ephem for t in toas_list}
    out = TOAs(
        TimeArray(
            np.concatenate([t.t.mjd_int for t in toas_list]),
            HostDD(
                np.concatenate([t.t.sec.hi for t in toas_list]),
                np.concatenate([t.t.sec.lo for t in toas_list]),
            ),
            t0.t.scale,
        ),
        np.concatenate([t.freq for t in toas_list]),
        np.concatenate([t.error_us for t in toas_list]),
        sum((t.obs for t in toas_list), []),
        sum(([dict(f) for f in t.flags] for t in toas_list), []),
    )
    if any(t.t.scale != t0.t.scale for t in toas_list):
        raise ValueError("cannot merge TOAs with different time scales")
    for col in TOAs._COMPUTED_COLS:
        vals = [getattr(t, col) for t in toas_list]
        if all(v is not None for v in vals):
            setattr(out, col, np.concatenate(vals))
    if all(t.t_tdb is not None for t in toas_list):
        out.t_tdb = TimeArray(
            np.concatenate([t.t_tdb.mjd_int for t in toas_list]),
            HostDD(
                np.concatenate([t.t_tdb.sec.hi for t in toas_list]),
                np.concatenate([t.t_tdb.sec.lo for t in toas_list]),
            ),
            "tdb",
        )
    bodies = set().union(*(t.obs_planet_pos for t in toas_list))
    for b in bodies:
        if all(b in t.obs_planet_pos for t in toas_list):
            out.obs_planet_pos[b] = np.concatenate(
                [t.obs_planet_pos[b] for t in toas_list]
            )
    # single shared tag propagates; a mix (e.g. tagged + never-
    # ingested) leaves the merged set untagged
    out.ephem = ephems.pop() if len(ephems) == 1 else None
    for t in toas_list:
        out.clock_info.update(t.clock_info)
    out.sort()
    return out
