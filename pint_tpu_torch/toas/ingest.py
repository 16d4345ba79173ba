"""TOA ingest pipeline: clock chain -> TDB -> solar-system geometry.

Counterpart of ``pint_tpu/toas/ingest.py``: the load-time stack of
PINT's TOAs.apply_clock_corrections, compute_TDBs and compute_posvels,
all on the host (numpy/HostDD); its outputs are the computed columns
that ``TOAs.table`` hands to ``make_bundle``.

- barycentric ingest (site '@' / 'bat'): arrival times are already TDB
  at the SSB (tempo2 BAT convention); geometry columns are zero.
- observatory ingest (``toas/ingest_topo.py``): clock chain (site clock
  files + GPS->UTC + BIPM), UTC->TDB, observatory positions.
"""

from __future__ import annotations

import warnings

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs

BARY_SITES = {"@", "bat", "barycenter", "ssb"}


def ingest_barycentric(toas: TOAs) -> TOAs:
    """Site-'@' ingest: times are TDB at the barycenter; zero geometry."""
    bad = [o for o in toas.obs if o.lower() not in BARY_SITES]
    if bad:
        raise PintTpuError(
            "ingest_barycentric: non-barycentric sites "
            f"{sorted(set(bad))}"
        )
    toas.t_tdb = TimeArray(toas.t.mjd_int, toas.t.sec, "tdb")
    n = len(toas)
    toas.clock_corr_s = np.zeros(n)
    toas.ssb_obs_pos = np.zeros((n, 3))
    toas.ssb_obs_vel = np.zeros((n, 3))
    toas.obs_sun_pos = np.zeros((n, 3))
    return toas


def ingest(toas: TOAs, ephem: str = "builtin", planets: bool = False,
           include_bipm: bool = True, bipm_version: str = "BIPM2021",
           limits: str = "warn", model=None) -> TOAs:
    """Full observatory ingest (clock chain -> TDB -> posvels)."""
    if all(o.lower() in BARY_SITES for o in toas.obs):
        return ingest_barycentric(toas)
    from pint_tpu_torch.toas.ingest_topo import ingest_topocentric

    return ingest_topocentric(
        toas, ephem=ephem, planets=planets,
        include_bipm=include_bipm, bipm_version=bipm_version,
        limits=limits, model=model,
    )


def ingest_for_model(toas: TOAs, model, **kw) -> TOAs:
    """Ingest with the model's own EPHEM / PLANET_SHAPIRO / CLOCK
    options: the one helper every caller (builder, simulation, TZR)
    uses, so that data TOAs and derived TOAs go through identical
    chains."""
    eph = model.top_params.get("EPHEM")
    kw.setdefault("ephem", (eph.value if eph is not None else None)
                  or "builtin")
    ps = model.params.get("PLANET_SHAPIRO")
    kw.setdefault(
        "planets", bool(ps.value) if ps is not None else False
    )
    # CLOCK card (PINT: get_TOAs include_bipm/bipm_version from
    # model.CLOCK): "TT(BIPM2021)" -> that BIPM realization;
    # "TT(TAI)" / "UTC(NIST)"-style -> plain TT(TAI).
    clk = model.top_params.get("CLOCK")
    clk_val = (clk.value or "").upper().replace(" ", "") if clk else ""
    if (clk_val.startswith("TT(BIPM") and clk_val.endswith(")")
            and clk_val[7:-1].isdigit()):
        kw.setdefault("include_bipm", True)
        kw.setdefault("bipm_version", clk_val[3:-1])
    elif clk_val in ("TT(TAI)", "UTC(NIST)", "UTC"):
        kw.setdefault("include_bipm", False)
    elif clk_val:
        # 'TT(BIPM)' with no year, 'UTC(obs)' realizations, typos: do
        # not silently ignore the par file's timescale intent; say what
        # default is taking over.
        warnings.warn(
            f"unrecognized CLOCK {clk.value!r} in par file; assuming "
            "the default TT(BIPM2021) realization"
        )
    return ingest(toas, model=model, **kw)
