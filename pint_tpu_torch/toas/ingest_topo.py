"""Topocentric TOA ingest: clock chain -> TDB -> solar-system geometry.

Counterpart of ``pint_tpu/toas/ingest_topo.py`` (PINT's
TOAs.apply_clock_corrections, compute_TDBs and compute_posvels): all
host-side numpy/HostDD; the products become TOABundle device columns.

Chain per TOA:
  1. site clock (+ GPS->UTC)            [observatory registry + .clk files]
  2. UTC -> TAI -> TT(TAI) [+ TT(BIPM)] [timebase.TimeArray + leap seconds]
  3. TT -> TDB (geocentric series) + topocentric (v_earth . r_obs)/c^2
  4. observatory ITRF -> GCRS posvel    [earth.rotation, EOP table]
  5. Earth/Sun/planet SSB posvels       [ephemeris: SPK or builtin]
  6. source elevation (troposphere), when the model's astrometry is known

Execution model: every stage is a pure per-TOA map (no cross-TOA
reduction anywhere in the chain), so the TOA table is CHUNKED and the
chunks fan out across a thread pool (numpy releases the GIL on the
large-array kernels that dominate: the 54-term nutation series, the TDB
series, the SPK Chebyshev evaluation).  The once-per-dataset costs
(clock-file discovery and composition, EOP table load, SPK segment-chain
routing, source direction) are hoisted into an :class:`IngestPlan` built
serially up front, so workers share read-only prepared state.  Chunked
output is bit-identical to the serial path: concatenating per-element
maps commutes with slicing.

``$PINT_TPU_INGEST_WORKERS`` sets the pool width (0 or 1 = serial;
unset = min(8, usable cores)).  A worker failure degrades to one clean
serial pass (with a warning), so parallel ingest can never produce an
answer serial ingest would not.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pint_tpu_torch.constants import C
from pint_tpu_torch.earth.eop import get_eop
from pint_tpu_torch.earth.rotation import (
    OMEGA_EARTH,
    itrf_to_gcrs_matrix,
    itrf_to_geodetic,
)
from pint_tpu_torch.ephemeris import get_ephemeris, mjd_tdb_to_et
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.observatory import bipm_correction, get_observatory
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs

# NAIF ids for the PLANET_SHAPIRO bodies
_PLANETS = {
    "jupiter": 5, "saturn": 6, "venus": 2, "uranus": 7, "neptune": 8,
}

#: Cache-key component for the persistent ingest-column cache
#: (toas/cache.py): bump whenever the numerics of this chain change so
#: stale cached columns can never masquerade as current ones.  The
#: "torch-" tag keeps the port's cache files apart from the reference's.
INGEST_CODE_VERSION = "torch-ingest-1"

#: Below this many TOAs a thread pool costs more than it saves; the
#: chain runs as one serial chunk.
_MIN_PARALLEL_TOAS = 16384


def ingest_workers() -> int:
    """Worker-pool width for chunked ingest: $PINT_TPU_INGEST_WORKERS
    (0 or 1 = serial), default min(8, usable cores).  'Usable' is the
    scheduler AFFINITY mask where the platform exposes it — cgroup
    -pinned containers report the full machine in cpu_count(), and a
    pool wider than the mask only adds GIL convoying."""
    env = os.environ.get("PINT_TPU_INGEST_WORKERS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            warnings.warn(
                f"ignoring non-integer PINT_TPU_INGEST_WORKERS={env!r}"
            )
    try:
        usable = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        usable = os.cpu_count() or 1
    return min(8, usable)


class IngestPlan:
    """Once-per-dataset ingest state, hoisted out of the per-TOA chain.

    Built serially BEFORE the chunk fan-out so that (a) lazy loaders —
    clock-file discovery + composition, the EOP table, the ephemeris
    kernel and its SSB segment-chain routing — run exactly once instead
    of per TOA group per chunk, and (b) their one-time warnings/errors
    (missing clock file with limits='error', missing BIPM realization,
    absent EOP table) fire in the caller's thread with serial-identical
    semantics.  Workers only READ this object.
    """

    def __init__(self, toas: TOAs, ephem, planets, include_bipm,
                 bipm_version, include_gps, limits, model):
        self.ephem_name = ephem
        self.planets = bool(planets)
        self.include_bipm = bool(include_bipm)
        self.bipm_version = bipm_version
        self.include_gps = bool(include_gps)
        self.limits = limits
        # -- observatory resolution + clock-chain composition ------------
        self.sites = {
            code: get_observatory(code) for code in sorted(set(toas.obs))
        }
        self.itrf = {}
        empty = np.empty(0)
        for code, site in self.sites.items():
            if site.is_satellite:
                continue
            # prewarm: loads + composes the site clock files (and the
            # GPS steering file) once; emits the no-clock warning or
            # MissingClockCorrection (limits='error') exactly where the
            # serial chain used to
            site.clock_corrections(
                empty, include_gps=include_gps, limits=limits
            )
            loc = site.earth_location_itrf()
            self.itrf[code] = (
                np.zeros(3) if loc is None else np.asarray(loc, float)
            )
        if self.include_bipm:
            bipm_correction(empty, bipm_version)  # prewarm + warn-once
        get_eop(empty)  # prewarm the EOP table (env load + warn-once)
        self.eph = get_ephemeris(ephem)
        # hoist the SSB segment-chain routing (SPK kernels re-walked
        # the pair graph per call otherwise; ephemeris/spk.py memoizes
        # via ssb_chain) for every body this ingest will evaluate
        targets = [399, 10] + (
            [naif for naif in _PLANETS.values()] if self.planets else []
        )
        if hasattr(self.eph, "ssb_chain"):
            for t in targets:
                self.eph.ssb_chain(t)
        self.src = _source_unit_vector(model)


def ingest_topocentric(
    toas: TOAs,
    ephem: str = "builtin",
    planets: bool = False,
    include_bipm: bool = True,
    bipm_version: str = "BIPM2021",
    include_gps: bool = True,
    limits: str = "warn",
    model=None,
) -> TOAs:
    n = len(toas)
    sites = [get_observatory(o) for o in toas.obs]
    if any(s.is_barycenter for s in sites):
        if all(s.is_barycenter for s in sites):
            from pint_tpu_torch.toas.ingest import ingest_barycentric

            return ingest_barycentric(toas)
        raise PintTpuError(
            "mixed barycentric + topocentric TOAs in one set are not "
            "supported; split the tim file"
        )
    if toas.t.scale != "utc":
        raise PintTpuError(
            f"topocentric ingest expects UTC arrival times, got "
            f"{toas.t.scale!r}"
        )

    plan = IngestPlan(
        toas, ephem, planets, include_bipm, bipm_version,
        include_gps, limits, model,
    )

    workers = ingest_workers()
    nchunks = 1
    if workers > 1 and n >= _MIN_PARALLEL_TOAS:
        nchunks = min(workers, max(1, n // (_MIN_PARALLEL_TOAS // 2)))
    edges = np.linspace(0, n, nchunks + 1).astype(int)

    if nchunks == 1:
        parts = [_compute_chunk(plan, toas.t, toas.obs, 0, n, 0)]
    else:
        parts = _run_parallel(plan, toas, edges)
    _apply_columns(toas, parts, plan)
    return toas


def _run_parallel(plan: IngestPlan, toas: TOAs, edges) -> list:
    """Fan chunks across a thread pool; any worker failure degrades to
    one clean serial pass (the parallel path must never produce an
    answer — or an error — the serial path would not)."""
    nchunks = len(edges) - 1
    try:
        with ThreadPoolExecutor(max_workers=nchunks) as pool:
            futs = [
                pool.submit(
                    _compute_chunk, plan, toas.t, toas.obs,
                    int(edges[k]), int(edges[k + 1]), k,
                )
                for k in range(nchunks)
            ]
            return [f.result() for f in futs]
    except Exception as e:  # degrade: serial recompute, then re-raise
        # only if the serial chain fails too (a genuine data error)
        warnings.warn(
            f"parallel ingest worker failed ({e!r}); recomputing "
            "serially"
        )
        return [_compute_chunk(plan, toas.t, toas.obs, 0, len(toas), 0)]


def _compute_chunk(plan: IngestPlan, t_all: TimeArray, obs_all,
                   lo: int, hi: int, chunk: int) -> dict:
    """The per-TOA chain on rows [lo, hi): a pure function of the
    prepared plan + the raw arrival rows — returns host column arrays,
    mutates nothing.  Chunking is exact: every stage maps elementwise
    over the TOA axis (interpolation, series evaluation, Chebyshev
    records, rotation matrices), so slice-then-compute equals
    compute-then-slice bitwise."""
    t = t_all[lo:hi]
    obs = list(obs_all[lo:hi])
    n = hi - lo
    out = {}

    # -- 1. clock chain ---------------------------------------------------
    mjd_utc = t.mjd_float()
    clock = np.zeros(n)
    itrf = np.zeros((n, 3))
    sat_groups = []  # (bool index, SatelliteObs)
    for code in sorted(set(obs)):
        idx = np.array([o == code for o in obs])
        site = plan.sites[code]
        if site.is_satellite:
            # spacecraft clocks are corrected upstream in the event
            # products; position comes from the orbit table below
            sat_groups.append((idx, site))
            continue
        clock[idx] = site.clock_corrections(
            mjd_utc[idx], include_gps=plan.include_gps,
            limits=plan.limits,
        )
        itrf[idx] = plan.itrf[code]
    out["clock_corr_s"] = clock
    t_utc = t.add_seconds(clock)

    # -- 2. UTC -> TT -----------------------------------------------------
    t_tt = t_utc.to_scale("tt")
    if plan.include_bipm:
        bipm = bipm_correction(mjd_utc, plan.bipm_version)
        # spacecraft times are corrected upstream in the event
        # products: no BIPM realization either (reference: satellite
        # observatories default include_bipm=False)
        for idx, _sat in sat_groups:
            bipm[idx] = 0.0
        t_tt = t_tt.add_seconds(bipm)

    # -- 4. Earth rotation (needed for the TDB topocentric term) ----------
    dut1, xp, yp = get_eop(mjd_utc)
    mjd_ut1 = t_utc.mjd_float() + dut1 / 86400.0
    tt_cent = (
        (t_tt.mjd_int - 51544.5) + t_tt.sec.to_float() / 86400.0
    ) / 36525.0
    # one rotation-matrix build serves position, velocity, and the
    # troposphere's local-vertical below (the nutation series
    # dominates the per-TOA geometry cost)
    M = itrf_to_gcrs_matrix(mjd_ut1, tt_cent, xp, yp)
    obs_pos = (M @ itrf[..., None])[..., 0]
    omega = np.array([0.0, 0.0, OMEGA_EARTH])
    obs_vel = (
        M @ np.cross(
            np.broadcast_to(omega, itrf.shape), itrf
        )[..., None]
    )[..., 0]
    # spacecraft rows: orbit-table interpolation (already GCRS)
    if sat_groups:
        mjd_tt_f = t_tt.mjd_float()
        for idx, sat in sat_groups:
            obs_pos[idx], obs_vel[idx] = sat.posvel_gcrs(
                mjd_tt_f[idx]
            )

    # -- 3. TT -> TDB (geocentric series + topocentric term) --------------
    t_tdb = t_tt.to_scale("tdb")
    eph = plan.eph
    et = mjd_tdb_to_et(t_tdb.mjd_int, t_tdb.sec.to_float())
    epos_km, evel_km = eph.ssb_posvel(399, et)
    topo_s = np.sum(evel_km * 1000.0 * obs_pos, axis=-1) / (C * C)
    t_tdb = t_tdb.add_seconds(topo_s)
    out["t_tdb"] = t_tdb

    # -- 5. geometry columns (meters, m/s) --------------------------------
    # re-evaluate at the corrected TDB (the ~us shift moves Earth
    # by ~cm)
    et = mjd_tdb_to_et(t_tdb.mjd_int, t_tdb.sec.to_float())
    epos_km, evel_km = eph.ssb_posvel(399, et)
    out["ssb_obs_pos"] = epos_km * 1000.0 + obs_pos
    out["ssb_obs_vel"] = evel_km * 1000.0 + obs_vel
    spos_km, _ = eph.ssb_posvel(10, et)
    out["obs_sun_pos"] = spos_km * 1000.0 - out["ssb_obs_pos"]
    planet_pos = {}
    if plan.planets:
        for name, naif in _PLANETS.items():
            ppos_km, _ = eph.ssb_posvel(naif, et)
            planet_pos[name] = ppos_km * 1000.0 - out["ssb_obs_pos"]
    out["planet_pos"] = planet_pos

    # -- 6. troposphere geometry ------------------------------------------
    on_ground = np.linalg.norm(itrf, axis=-1) > 1e6  # geocenter: no air
    lat, lon, height = itrf_to_geodetic(
        np.where(on_ground[:, None], itrf, [6378137.0, 0.0, 0.0])
    )
    lat = np.where(on_ground, lat, 0.0)
    height = np.where(on_ground, height, 0.0)
    out["obs_lat_rad"] = lat
    out["obs_alt_m"] = height
    if plan.src is not None:
        # geodetic normal in ITRF, rotated to GCRS with the same
        # matrix chain used for the position
        normal_itrf = np.stack(
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
             np.sin(lat)], axis=-1
        )
        normal_gcrs = (M @ normal_itrf[..., None])[..., 0]
        elev = np.arcsin(
            np.clip(np.sum(normal_gcrs * plan.src, axis=-1),
                    -1.0, 1.0)
        )
        # no troposphere for geocentric/space sites: elevation <= 0
        # makes TroposphereDelay's validity mask false
        out["obs_elevation_rad"] = np.where(
            on_ground, elev, -np.pi / 2
        )
    return out


def _apply_columns(toas: TOAs, parts: list, plan: IngestPlan):
    """Concatenate per-chunk column dicts back onto the TOAs table."""
    def cat(key):
        if len(parts) == 1:
            return parts[0][key]
        return np.concatenate([p[key] for p in parts])

    tdbs = [p["t_tdb"] for p in parts]
    if len(tdbs) == 1:
        toas.t_tdb = tdbs[0]
    else:
        toas.t_tdb = TimeArray(
            np.concatenate([x.mjd_int for x in tdbs]),
            HostDD(
                np.concatenate([x.sec.hi for x in tdbs]),
                np.concatenate([x.sec.lo for x in tdbs]),
            ),
            "tdb",
        )
    toas.clock_corr_s = cat("clock_corr_s")
    toas.ssb_obs_pos = cat("ssb_obs_pos")
    toas.ssb_obs_vel = cat("ssb_obs_vel")
    toas.obs_sun_pos = cat("obs_sun_pos")
    toas.obs_planet_pos = {}
    for name in parts[0]["planet_pos"]:
        if len(parts) == 1:
            toas.obs_planet_pos[name] = parts[0]["planet_pos"][name]
        else:
            toas.obs_planet_pos[name] = np.concatenate(
                [p["planet_pos"][name] for p in parts]
            )
    toas.ephem = getattr(plan.eph, "name", str(plan.ephem_name))
    toas.obs_lat_rad = cat("obs_lat_rad")
    toas.obs_alt_m = cat("obs_alt_m")
    if plan.src is not None:
        toas.obs_elevation_rad = cat("obs_elevation_rad")


def _source_unit_vector(model):
    """Host-side source direction (ICRS unit vector) from the model's
    astrometry component, or None."""
    if model is None:
        return None
    comp = None
    for name in ("AstrometryEquatorial", "AstrometryEcliptic"):
        comp = model.components.get(name) or comp
    if comp is None:
        return None
    def _f(p):
        v = p.internal()
        return float(v.to_float()) if hasattr(v, "to_float") else float(v)

    if "RAJ" in comp.params and comp.params["RAJ"].value is not None:
        ra = _f(comp.params["RAJ"])
        dec = _f(comp.params["DECJ"])
    elif (
        "ELONG" in comp.params and comp.params["ELONG"].value is not None
    ):
        lam = _f(comp.params["ELONG"])
        bet = _f(comp.params["ELAT"])
        eps = np.deg2rad(84381.406 / 3600.0)
        x = np.cos(bet) * np.cos(lam)
        y = np.cos(eps) * np.cos(bet) * np.sin(lam) - np.sin(eps) * np.sin(bet)
        z = np.sin(eps) * np.cos(bet) * np.sin(lam) + np.cos(eps) * np.sin(bet)
        return np.array([x, y, z])
    else:
        return None
    return np.array([
        np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)
    ])
