"""Persistent TOA ingest cache: skip the clock/TDB/posvel pipeline on
reload, and re-ingest only the appended tail when a tim file grows.

Counterpart of ``pint_tpu/toas/cache.py`` (PINT's get_TOAs(usepickle=True)
writes <tim>.pickle.gz keyed by a content hash).  The ingested columns
are saved as ``<tim>.torch-ingest.npz`` next to the tim file (or in
``$PINT_TPU_CACHE_DIR``), double-double columns round-tripping exactly
(hi/lo pairs).  The file name and the key's code-version tag
(``ingest_topo.INGEST_CODE_VERSION``) both differ from the JAX
package's, so neither package ever loads the other's cache.

Cache key: three independent components, each invalidating on its own
axis —
  * ``content_hash``  — sha256 of the tim file bytes (data changed);
  * ``options_key``   — ingest options incl. the model's par-file text
    (ephemeris/BIPM/planets choices changed);
  * baked into ``options_key``: the npz ``_FORMAT_VERSION`` and
    ingest_topo.INGEST_CODE_VERSION (the ingest numerics changed —
    bumping either orphans every existing cache file).

Append-incremental reuse: observation runs APPEND TOAs, and the common
"new day of data" reload shares every earlier row bit for bit.  When the
content hash misses but the options key matches and the cached rows are
exactly a prefix of the new tim rows (arrival times, freqs, errors,
sites, flags all equal), only the tail is ingested and the columns are
stitched.  This is exact because the ingest chain is a pure per-TOA map
(see ingest_topo's chunking contract).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs

_FORMAT_VERSION = 3

#: the port's cache file suffix (the JAX package writes ".ingest.npz")
CACHE_SUFFIX = ".torch-ingest.npz"

#: per-TOA derived columns persisted alongside the raw rows
_DERIVED_COLS = (
    "clock_corr_s", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
    "obs_lat_rad", "obs_alt_m", "obs_elevation_rad",
)


def _cache_path(tim_path) -> Path:
    cdir = os.environ.get("PINT_TPU_CACHE_DIR")
    p = Path(tim_path)
    if cdir:
        return Path(cdir) / (p.name + CACHE_SUFFIX)
    return p.with_name(p.name + CACHE_SUFFIX)


def _options_key(**options) -> str:
    """Hash of everything except the tim content: ingest options + the
    npz format version + the ingest-chain code version."""
    from pint_tpu_torch.toas.ingest_topo import INGEST_CODE_VERSION
    from pint_tpu_torch.utils import compute_hash

    return compute_hash(
        _FORMAT_VERSION, INGEST_CODE_VERSION, sorted(options.items())
    )


def _content_hash(tim_path) -> str:
    from pint_tpu_torch.utils import compute_hash

    return compute_hash(tim_path)


def _flags_json(toas: TOAs) -> np.ndarray:
    """Every TOA's flags as one JSON string of [key, value] pair lists
    (one ``json.loads`` reads them back: a literal-eval a row took 40 us,
    longer than ingesting the row)."""
    return np.array(json.dumps([list(f.items()) for f in toas.flags]))


def save_cache(toas: TOAs, tim_path, **options):
    """Write the ingested TOA columns keyed on tim content + options +
    code version."""
    arrs = {
        "options_key": np.array(_options_key(**options)),
        "content_hash": np.array(_content_hash(tim_path)),
        "t_day": toas.t.mjd_int, "t_hi": toas.t.sec.hi,
        "t_lo": toas.t.sec.lo, "t_scale": np.array(toas.t.scale),
        "freq": toas.freq, "error_us": toas.error_us,
        "obs": np.array(toas.obs),
        "flags": _flags_json(toas),
    }
    if toas.ephem is not None:
        arrs["ephem"] = np.array(toas.ephem)
    if toas.t_tdb is not None:
        arrs.update(
            tdb_day=toas.t_tdb.mjd_int, tdb_hi=toas.t_tdb.sec.hi,
            tdb_lo=toas.t_tdb.sec.lo,
        )
    for col in _DERIVED_COLS:
        v = getattr(toas, col)
        if v is not None:
            arrs[col] = v
    for body, v in toas.obs_planet_pos.items():
        arrs[f"planet:{body}"] = v
    np.savez_compressed(_cache_path(tim_path), **arrs)


def _toas_from_npz(z) -> TOAs:
    flags = [dict(f) for f in json.loads(str(z["flags"]))]
    t = TimeArray(
        z["t_day"], HostDD(z["t_hi"], z["t_lo"]), str(z["t_scale"])
    )
    toas = TOAs(t, z["freq"], z["error_us"], z["obs"].tolist(), flags)
    if "tdb_day" in z:
        toas.t_tdb = TimeArray(
            z["tdb_day"], HostDD(z["tdb_hi"], z["tdb_lo"]), "tdb"
        )
    for col in _DERIVED_COLS:
        if col in z:
            setattr(toas, col, z[col])
    for name in z.files:
        if name.startswith("planet:"):
            toas.obs_planet_pos[name.split(":", 1)[1]] = z[name]
    if "ephem" in z:
        toas.ephem = str(z["ephem"])
    return toas


def _load_npz(tim_path, **options):
    """The cache npz when it exists and its options/version key
    matches; None otherwise (content hash NOT checked here)."""
    path = _cache_path(tim_path)
    if not path.exists():
        return None
    try:
        z = np.load(path, allow_pickle=False)
    except (OSError, ValueError):
        return None
    key = "options_key" if "options_key" in z.files else "key"
    if str(z[key]) != _options_key(**options):
        return None
    return z


def load_cache(tim_path, **options) -> Optional[TOAs]:
    """Ingested TOAs from cache, or None on miss/stale key (content,
    options, or code version changed)."""
    z = _load_npz(tim_path, **options)
    if z is None or "content_hash" not in z.files:
        return None
    if str(z["content_hash"]) != _content_hash(tim_path):
        return None
    return _toas_from_npz(z)


def _prefix_rows_match(cached: TOAs, new: TOAs) -> bool:
    """True when the cached rows are exactly the first len(cached) raw
    rows of the new tim parse (times, freqs, errors, sites, flags)."""
    nc = len(cached)
    if nc == 0 or nc > len(new):
        return False
    head = new[:nc]
    return (
        cached.t.scale == head.t.scale
        and np.array_equal(cached.t.mjd_int, head.t.mjd_int)
        and np.array_equal(cached.t.sec.hi, head.t.sec.hi)
        and np.array_equal(cached.t.sec.lo, head.t.sec.lo)
        and np.array_equal(cached.freq, head.freq)
        and np.array_equal(cached.error_us, head.error_us)
        and cached.obs == head.obs
        and cached.flags == head.flags
    )


def _stitch_columns(full: TOAs, prefix: TOAs, tail: TOAs):
    """Copy ingested columns onto ``full`` by concatenating the cached
    prefix with the freshly-ingested tail, preserving ROW ORDER (no
    re-sort: the stitched table must be bitwise the full-ingest one)."""
    full.t_tdb = TimeArray(
        np.concatenate([prefix.t_tdb.mjd_int, tail.t_tdb.mjd_int]),
        HostDD(
            np.concatenate([prefix.t_tdb.sec.hi, tail.t_tdb.sec.hi]),
            np.concatenate([prefix.t_tdb.sec.lo, tail.t_tdb.sec.lo]),
        ),
        "tdb",
    )
    for col in _DERIVED_COLS:
        a, b = getattr(prefix, col), getattr(tail, col)
        if a is not None and b is not None:
            setattr(full, col, np.concatenate([a, b]))
    for body in tail.obs_planet_pos:
        if body in prefix.obs_planet_pos:
            full.obs_planet_pos[body] = np.concatenate(
                [prefix.obs_planet_pos[body], tail.obs_planet_pos[body]]
            )
    full.ephem = tail.ephem if tail.ephem is not None else prefix.ephem


def append_ingested(base: TOAs, tail: TOAs, model=None,
                    **ingest_kw) -> TOAs:
    """In-memory sibling of :func:`get_TOAs`'s append-incremental path:
    ingest ONLY the appended ``tail`` (the base's computed columns are
    reused as they are) and merge.  The merge time-sorts and refuses
    inconsistent ephemerides (toas/toas.py::merge_TOAs)."""
    from pint_tpu_torch.toas.ingest import ingest, ingest_for_model
    from pint_tpu_torch.toas.toas import merge_TOAs

    if base.t_tdb is None:
        raise ValueError(
            "append_ingested needs an already-ingested base TOA set"
        )
    if tail.t_tdb is None:
        if model is not None:
            ingest_for_model(tail, model, **ingest_kw)
        else:
            ingest(tail, **ingest_kw)
    return merge_TOAs([base, tail])


def get_TOAs(
    tim_path,
    model=None,
    usepickle: bool = False,
    **ingest_kw,
) -> TOAs:
    """tim file -> ingested TOAs, with optional caching (the
    reference's get_TOAs(usepickle=...) surface).

    With ``usepickle=True``: an exact cache hit (content + options +
    code version) skips ingest entirely; a grown tim file whose old
    rows are an unchanged prefix re-ingests ONLY the appended tail;
    anything else re-ingests in full and refreshes the cache."""
    from pint_tpu_torch.toas import ingest as ingest_mod

    opts = dict(ingest_kw)
    if model is not None:
        opts["model_par"] = model.as_parfile()

    def _ingest(t):
        if model is not None:
            return ingest_mod.ingest_for_model(t, model, **ingest_kw)
        return ingest_mod.ingest(t, **ingest_kw)

    cached_prefix = None
    if usepickle:
        cached = load_cache(tim_path, **opts)
        if cached is not None:
            return cached
        z = _load_npz(tim_path, **opts)
        if z is not None and "content_hash" in z.files:
            cached_prefix = _toas_from_npz(z)

    from pint_tpu_torch.io.tim import get_TOAs_from_tim

    toas = get_TOAs_from_tim(tim_path)
    if (
        cached_prefix is not None
        and cached_prefix.t_tdb is not None
        and _prefix_rows_match(cached_prefix, toas)
    ):
        nc = len(cached_prefix)
        tail = _ingest(toas[nc:])
        _stitch_columns(toas, cached_prefix, tail)
        save_cache(toas, tim_path, **opts)
        return toas

    toas = _ingest(toas)
    if usepickle:
        save_cache(toas, tim_path, **opts)
    return toas
