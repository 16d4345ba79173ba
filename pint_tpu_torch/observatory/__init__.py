"""Observatory registry: names/aliases -> locations + clock chains.

Counterpart of ``pint_tpu/observatory/`` (PINT's observatory registry,
get_observatory, TopoObs and special locations): embedded ITRF
coordinates for the major pulsar observatories
(reference: data/runtime/observatories.json), overridable via
$PINT_TPU_OBS_OVERRIDE (a JSON file of the same shape), clock files
discovered in $PINT_TPU_CLOCK_DIR (tempo2 layout: <name>2gps.clk,
gps2utc.clk, tai2tt_bipm20XX.clk).

Coordinate provenance: public VLBI/GPS site positions as collected in
the reference's observatories.json; entries are meter-level [verify
against the reference mount for cm-level parity when readable].
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np

from pint_tpu_torch.exceptions import MissingClockCorrection, UnknownObservatory
from pint_tpu_torch.io.clock import ClockFile

# name -> (itrf xyz meters, aliases incl. tempo codes)
_OBS_DATA = {
    "gbt": ([882589.65, -4924872.32, 3943729.348], ["1", "gb"]),
    "arecibo": ([2390487.080, -5564731.357, 1994720.633], ["3", "ao"]),
    "vla": ([-1601192.0, -5041981.4, 3554871.34], ["6", "jvla"]),
    "parkes": ([-4554231.5, 2816759.1, -3454036.3], ["7", "pks"]),
    "jodrell": ([3822626.04, -154105.65, 5086486.04], ["8", "jb"]),
    "nancay": ([4324165.81, 165927.11, 4670132.83], ["f", "ncy", "ncyobs"]),
    "effelsberg": ([4033949.5, 486989.4, 4900430.8], ["g", "eff"]),
    "wsrt": ([3828445.659, 445223.600, 5064921.568], ["i"]),
    "gmrt": ([1656342.30, 5797947.77, 2073243.16], ["r"]),
    "meerkat": ([5109360.133, 2006852.586, -3238948.127], ["m", "mkt"]),
    "fast": ([-1668557.21, 5506838.14, 2744934.98], ["k"]),
    "chime": ([-2059166.313, -3621302.972, 4814304.113], ["y"]),
    "lofar": ([3826577.462, 461022.624, 5064892.526], ["t"]),
    "srt": ([4865182.766, 791922.689, 4035137.174], ["z", "sardinia"]),
    "hartrao": ([5085442.780, 2668263.483, -2768697.034], ["hart"]),
    "hobart": ([-3950077.96, 2522377.31, -4311667.52], ["4", "ho"]),
    "mwa": ([-2559454.08, 5095372.14, -2849057.18], ["u"]),
    "lwa1": ([-1602196.60, -5042313.47, 3553971.51], ["x", "lwa"]),
    "ort": ([1827199.8, 6160762.8, 1197851.3], ["ooty"]),
}


class Observatory:
    """Base: named location with a clock-correction chain."""

    def __init__(self, name: str, aliases=()):
        self.name = name
        self.aliases = tuple(a.lower() for a in aliases)

    # -- interface -------------------------------------------------------
    def earth_location_itrf(self) -> Optional[np.ndarray]:
        return None

    def clock_corrections(self, mjd_utc, include_gps=True,
                          limits="warn") -> np.ndarray:
        """Seconds to ADD to the observatory UTC to get UTC(GPS-steered)."""
        return np.zeros_like(np.asarray(mjd_utc, dtype=np.float64))

    @property
    def is_barycenter(self):
        return False

    @property
    def is_satellite(self):
        return False

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class TopoObs(Observatory):
    """Ground observatory with ITRF coordinates + clock files."""

    def __init__(self, name, itrf_xyz, aliases=(), clock_files=None):
        super().__init__(name, aliases)
        self.itrf_xyz = np.asarray(itrf_xyz, dtype=np.float64)
        self.clock_files = clock_files
        self._clock: Optional[ClockFile] = None
        self._clock_tried = False

    def earth_location_itrf(self):
        return self.itrf_xyz

    def _find_clock(self):
        """<name>2gps.clk (tempo2 layout) in $PINT_TPU_CLOCK_DIR."""
        if self._clock_tried:
            return self._clock
        self._clock_tried = True
        cdir = os.environ.get("PINT_TPU_CLOCK_DIR")
        names = self.clock_files or [f"{self.name}2gps.clk"]
        if cdir:
            for fn in names:
                p = os.path.join(cdir, fn)
                if os.path.exists(p):
                    cf = ClockFile.from_tempo2(p, name=fn)
                    self._clock = cf if self._clock is None else (
                        self._clock + cf
                    )
        return self._clock

    def clock_corrections(self, mjd_utc, include_gps=True, limits="warn"):
        mjd = np.asarray(mjd_utc, dtype=np.float64)
        corr = np.zeros_like(mjd)
        site = self._find_clock()
        if site is not None:
            corr = corr + site.evaluate(mjd, limits=limits)
        else:
            msg = (
                f"no site clock file for {self.name!r} (set "
                f"$PINT_TPU_CLOCK_DIR); assuming UTC({self.name}) == GPS"
            )
            if limits == "error":
                raise MissingClockCorrection(msg)
            warnings.warn(msg)
        if include_gps:
            gps = _gps2utc_file()
            if gps is not None:
                corr = corr + gps.evaluate(mjd, limits=limits)
        return corr


class SpecialLocation(Observatory):
    """Barycenter / geocenter: no clock chain, no Earth position."""

    def __init__(self, name, aliases=(), barycenter=False):
        super().__init__(name, aliases)
        self._bary = barycenter

    @property
    def is_barycenter(self):
        return self._bary

    def earth_location_itrf(self):
        return None if self._bary else np.zeros(3)


_registry: dict[str, Observatory] = {}
_gps_clock: list = []  # memo cell


def _gps2utc_file() -> Optional[ClockFile]:
    if not _gps_clock:
        cdir = os.environ.get("PINT_TPU_CLOCK_DIR")
        p = os.path.join(cdir, "gps2utc.clk") if cdir else None
        _gps_clock.append(
            ClockFile.from_tempo2(p, name="gps2utc")
            if p and os.path.exists(p) else None
        )
    return _gps_clock[0]


def bipm_correction(mjd_utc, version: str = "BIPM2021") -> np.ndarray:
    """TT(BIPMxx) - TT(TAI) in seconds from
    $PINT_TPU_CLOCK_DIR/tai2tt_<version>.clk; zero (plain TT(TAI)) when
    absent."""
    cdir = os.environ.get("PINT_TPU_CLOCK_DIR")
    mjd = np.asarray(mjd_utc, dtype=np.float64)
    if cdir:
        p = os.path.join(cdir, f"tai2tt_{version.lower()}.clk")
        if os.path.exists(p):
            return ClockFile.from_tempo2(p, name=version).evaluate(
                mjd, limits="none"
            )
        # a clock environment exists but not this realization: the
        # requested TT(BIPMxx) silently degrading to TT(TAI) would lose
        # the par file's intent — say so.
        warnings.warn(
            f"requested BIPM realization {version!r} but {p} does not "
            "exist; using plain TT(TAI)"
        )
    return np.zeros_like(mjd)


_built = [False]


def _build_registry():
    if _built[0]:
        return
    _built[0] = True  # set first: register_observatory re-enters here
    data = _OBS_DATA
    override = os.environ.get("PINT_TPU_OBS_OVERRIDE")
    if override and os.path.exists(override):
        with open(override) as f:
            raw = json.load(f)
        data = {
            k.lower(): (v["itrf_xyz"], v.get("aliases", []))
            for k, v in raw.items()
        }
    for name, (xyz, aliases) in data.items():
        register_observatory(TopoObs(name, xyz, aliases=aliases))
    register_observatory(
        SpecialLocation(
            "barycenter", aliases=("@", "bat", "ssb"), barycenter=True
        )
    )
    register_observatory(
        SpecialLocation("geocenter", aliases=("0", "coe", "geo"))
    )


def register_observatory(obs: Observatory):
    # seed the built-ins first: registering a custom site as the very
    # first registry touch must not suppress gbt/parkes/barycenter/...
    _build_registry()
    _registry[obs.name.lower()] = obs
    for a in obs.aliases:
        _registry.setdefault(a, obs)


def reset_registry():
    """Clear the registry + caches (tests; $PINT_TPU_* env changes)."""
    _registry.clear()
    _gps_clock.clear()
    _built[0] = False


def get_observatory(name: str) -> Observatory:
    _build_registry()
    obs = _registry.get(str(name).lower())
    if obs is None:
        # satellite auto-registration: an orbit product named after
        # the site in $PINT_TPU_ORBIT_DIR makes the spacecraft usable
        # directly from tim-file site columns (reference:
        # observatory/satellite_obs.py::get_satellite_observatory,
        # which builds the observatory from an FT2/orbit file on
        # demand; the env-dir convention matches our clock/EOP/SPK
        # search paths)
        odir = os.environ.get("PINT_TPU_ORBIT_DIR")
        if odir:
            for ext in (".fits", ".orb"):
                p = os.path.join(odir, f"{str(name).lower()}{ext}")
                if os.path.exists(p):
                    from pint_tpu_torch.observatory.satellite import (
                        register_satellite,
                    )

                    return register_satellite(str(name).lower(), p)
        raise UnknownObservatory(
            f"unknown observatory {name!r}; known: "
            f"{sorted(set(o.name for o in _registry.values()))}"
        )
    return obs


def list_observatories() -> list[str]:
    _build_registry()
    return sorted({o.name for o in _registry.values()})
