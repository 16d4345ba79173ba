"""Simulated pulsars, built by the port alone.

Counterpart of ``pint_tpu/simulation.py``.  Two paths:

- :func:`make_fake_toas_uniform` / :func:`make_fake_toas_fromtim` (and
  :func:`make_test_pulsar` with ``obs=`` or ``mjds=``): port ``TOAs`` at
  any observatory, ingested through the port's clock chain, TDB and
  geometry (``toas/ingest.py``), the arrival times shifted until the
  model phase is integer.  The phase inversion runs on the caller's
  ``device``; the ingest between passes runs on the host, as in the
  reference.
- :func:`make_test_pulsar` without ``obs``: a host TOA table of
  site-'@' (barycentric TDB) arrivals, uniform in MJD with frequencies
  and receiver flags cycling, shifted to integer phase by the port's own
  model, then white jitter from ``np.random.default_rng(seed)``.  The
  host time arithmetic is the reference's (integer day + double-double
  seconds, carried exactly), so both packages build the same TOAs.

:func:`msp_par` writes the par text of the binary millisecond pulsar that
``chip_smoke.py`` and the tests drive: a NANOGrav-class ELL1 MSP modelled
on J1909-3744, with DMX ranges, FD, a JUMP and red noise.
:func:`msp_full_par` adds the solar wind, a TZR anchor, PHOFF and the DM
and chromatic Gaussian-process noise of EPTA- and IPTA-style models;
:func:`msp_wideband_par` the DMJUMP, DMEFAC and DMEQUAD of a wideband
release, whose TOAs ``make_test_pulsar(dm_error=...)`` gives DM
measurements; :func:`pta_pars` a pulsar timing array of pulsars of
``msp_par``'s composition, each with its own values.

A model with a TZR anchor (TZRSITE '@') gets its TZR row in the table's
``"tzr"`` entry, built by ``AbsPhase.tzr_table`` with the same synthetic
geometry as the data rows: on the orbit at TZRMJD when ``orbit=True``,
else at the barycentre.  With the orbit, a model with a solar-wind
component also gets the Sun at the barycentre (``obs_sun_pos_ls =
-ssb_obs_pos_ls``), so its solar-wind delay is not zero; other models
keep the Sun's position at zero, as before.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import AU, C, SECS_PER_DAY
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.timebase.hostdd import HostDD, carry_days
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.ingest import (
    BARY_SITES,
    ingest_barycentric,
    ingest_for_model,
)
from pint_tpu_torch.toas.toas import TOAs

#: the binary MSP's observing frequencies (MHz), cycled over the TOAs
#: while the receiver flags cycle over (L-wide, S-wide): every frequency
#: meets both receivers, so FD, JUMP and DMX are not degenerate
MSP_FREQS = (820.0, 1150.0, 1400.0, 1700.0, 2300.0)
#: the span the DMX ranges cover (MJD), that of the simulations
MSP_SPAN = (53000.0, 57500.0)


def _set_values(text: str, values: dict) -> str:
    """Par text with the value of each line named in ``values`` replaced
    (its fit flag kept)."""
    out = []
    for line in text.splitlines():
        tok = line.split()
        if tok and tok[0] in values:
            tok[1] = values[tok[0]]
            line = " ".join(tok)
        out.append(line)
    return "\n".join(out) + "\n"


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


def msp_full_par(ndmx: int = 150, seed: int = 0) -> str:
    """:func:`msp_par` with the remaining narrowband components of a
    published NANOGrav / EPTA par file: NE_SW (free), a barycentric TZR
    anchor, PHOFF, and 30-harmonic power-law DM and chromatic noise.
    Free: msp_par's and NE_SW (168 at 150 ranges; 169 design columns with
    the offset, so the joint Gram is q = 180 + 170 = 350).  PHOFF is held
    at 0: under a TZR anchor the reference subtracts it from the TZR
    row's phase too, so a free PHOFF would be a zero design column."""
    return msp_par(ndmx, seed) + "\n".join([
        "NE_SW 7.9 1", "TZRMJD 55000.1", "TZRSITE @", "TZRFRQ 1400",
        "PHOFF 0.0", "TNDMAMP -13.6", "TNDMGAM 2.8", "TNDMC 30",
        "TNCHROMAMP -14.0", "TNCHROMGAM 3.0", "TNCHROMC 30",
    ]) + "\n"


def msp_wideband_par(ndmx: int = 150, seed: int = 0) -> str:
    """:func:`msp_par` with golden17's wideband lines: a free DMJUMP on
    S-wide, DMEFAC on L-wide and DMEQUAD on S-wide.  Free: msp_par's and
    the DMJUMP (168 at 150 ranges; 169 design columns with the offset,
    so the stacked joint Gram is q = 60 + 170 = 230 over 2n rows)."""
    return msp_par(ndmx, seed) + "\n".join([
        "DMJUMP -f S-wide 3.2e-4 1", "DMEFAC -f L-wide 1.25",
        "DMEQUAD -f S-wide 1.5e-4",
    ]) + "\n"


def pta_pars(npsr: int = 45, ndmx: int = 100, seed: int = 0) -> list[str]:
    """Par texts of a pulsar timing array of ``npsr`` pulsars of
    :func:`msp_par`'s composition (so one PTA batch takes them), each
    with its own values drawn from ``default_rng(seed)``: F0 in 100-700
    Hz, F1, ELONG/ELAT, DM, the DMX values (its own seed), PEPOCH and
    POSEPOCH, and the orbit (PB, A1, TASC).  Free: 117 at 100 ranges (118
    design columns with the offset; with 60 red-noise columns the joint
    Gram is q = 179)."""
    rng = np.random.default_rng(seed)
    pars = []
    for i in range(npsr):
        pep = float(rng.integers(54000, 56500))
        tasc = 53000.0 + rng.uniform(0.0, 5.0)
        vals = {
            "PSR": f"JPTA{i:03d}SIM",
            "F0": f"{rng.uniform(100.0, 700.0):.14f}",
            "F1": f"{-10 ** rng.uniform(-16.0, -14.5):.6e}",
            "ELONG": f"{rng.uniform(0.0, 360.0):.6f}",
            "ELAT": f"{rng.uniform(-60.0, 60.0):.6f}",
            "DM": f"{rng.uniform(3.0, 80.0):.5f}",
            "PEPOCH": f"{pep:.1f}", "POSEPOCH": f"{pep:.1f}",
            "PB": f"{rng.uniform(0.5, 30.0):.12f}",
            "A1": f"{rng.uniform(1.0, 30.0):.8f}",
            "TASC": f"{tasc:.7f}",
        }
        pars.append(_set_values(msp_par(ndmx, seed=seed + 1 + i), vals))
    return pars


def pta_ntoas(npsr: int = 45, seed: int = 0, nmin: int = 4000,
              nmax: int = 10000) -> np.ndarray:
    """The PTA's TOA counts, drawn from ``default_rng(seed)`` in
    [nmin, nmax], the largest set to ``nmax``."""
    n = np.random.default_rng(seed + 0x7A).integers(nmin, nmax + 1, npsr)
    n[int(np.argmax(n))] = nmax
    return n


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


def _with_geometry(table, model, orbit: bool, start_mjd: float):
    """Put the synthetic observatory orbit (or the barycentre) on a table
    and on its TZR row; with the orbit, the Sun at the barycentre for a
    model that reads the solar wind."""
    sun = orbit and any(c.category == "solar_wind"
                        for c in model.components.values())

    def place(t, mjd_int, sec):
        if orbit:
            t["ssb_obs_pos_ls"] = orbit_pos_m(mjd_int, sec, start_mjd) / C
        if sun:
            t["obs_sun_pos_ls"] = -t["ssb_obs_pos_ls"]
        return t

    place(table, table["tdb_day"],
          HostDD(table["tdb_sec_hi"], table["tdb_sec_lo"]))
    anchor = model.tzr_anchor
    if anchor is not None:
        day, sec = anchor.params["TZRMJD"].value
        table["tzr"] = place(anchor.tzr_table(model), np.array([float(day)]),
                             HostDD([sec.hi], [sec.lo]))
    return table


def orbit_pos_m(mjd_int, sec: HostDD, start_mjd: float):
    """(n, 3) positions in metres on the synthetic observatory orbit: a
    circle of 1 AU in the x-y plane with a one-year period, phased from
    ``start_mjd``, at the epochs (integer MJD, HostDD seconds of day)."""
    ph = 2 * np.pi * (
        mjd_int + sec.to_float() / SECS_PER_DAY - start_mjd
    ) / 365.25
    return np.stack(
        [AU * np.cos(ph), AU * np.sin(ph), np.zeros_like(ph)], axis=-1
    )


def _ingest(toas: TOAs, model):
    if all(o.lower() in BARY_SITES for o in toas.obs):
        ingest_barycentric(toas)
    else:
        ingest_for_model(toas, model)


def _invert_to_integer_phase(toas: TOAs, model, iterations, device):
    """Shift arrival times until the model phase is (near-)integer: each
    pass evaluates the residuals on ``device`` and re-ingests on the
    host."""
    for _ in range(iterations):
        cm = model.compile(toas, device=device, subtract_mean=False)
        cm.track_mode = "nearest"
        resid = cm.time_residuals(cm.x0(), subtract_mean=False)
        toas.t = toas.t.add_seconds(-resid.cpu().numpy())
        _ingest(toas, model)


def _add_white_noise(toas: TOAs, model, rng):
    rng = rng or np.random.default_rng()
    toas.t = toas.t.add_seconds(rng.normal(0.0, toas.error_us * 1e-6))
    _ingest(toas, model)


def make_fake_toas_uniform(start_mjd: float, end_mjd: float, ntoa: int,
                           model, error_us: float = 1.0, freq_mhz=1400.0,
                           obs="@", add_noise: bool = False, rng=None,
                           iterations: int = 3, mjds=None, *,
                           device=None) -> TOAs:
    """Uniformly spaced TOAs whose model phase is (near-)integer
    (reference: ``simulation.make_fake_toas_uniform``).

    ``obs`` may be one code, a full per-TOA sequence (paired with the
    given ``mjds``, permuted together if they need sorting), or a short
    pattern that cycles over the time-sorted grid; ``mjds`` overrides
    the uniform grid with explicit epochs.  The inversion's residual
    sweeps run on ``device`` (None: the CUDA card)."""
    obs_list = None if isinstance(obs, str) else list(obs)
    if mjds is None:
        mjds = np.linspace(start_mjd, end_mjd, ntoa)
    else:
        mjds = np.asarray(mjds, dtype=np.float64)
        ntoa = len(mjds)
        order = np.argsort(mjds, kind="stable")
        if obs_list is not None and len(obs_list) == ntoa:
            obs_list = [obs_list[i] for i in order]  # keep the pairing
        mjds = mjds[order]
    freq = np.broadcast_to(np.asarray(freq_mhz, dtype=np.float64),
                           (ntoa,)).copy()
    t = TimeArray.from_mjd_float(mjds, scale="utc")
    if obs_list is None:
        obs_list = [obs] * ntoa
    elif len(obs_list) != ntoa:
        if len(obs_list) > ntoa:
            raise ValueError(
                f"obs sequence ({len(obs_list)}) longer than ntoa "
                f"({ntoa}); pass exactly ntoa codes or a short pattern")
        obs_list = [obs_list[i % len(obs_list)] for i in range(ntoa)]
    toas = TOAs(t, freq, np.full(ntoa, error_us), obs_list,
                [dict() for _ in range(ntoa)])
    _ingest(toas, model)
    _invert_to_integer_phase(toas, model, iterations, device)
    if add_noise:
        _add_white_noise(toas, model, rng)
    return toas


def make_fake_toas_fromtim(tim, model, add_noise: bool = False, rng=None,
                           iterations: int = 3, *, device=None) -> TOAs:
    """Model-perfect TOAs at the epochs, frequencies, errors and sites of
    an existing tim file (a path) or TOAs object, which is copied, never
    changed (reference: ``simulation.make_fake_toas_fromtim``)."""
    import os

    from pint_tpu_torch.io.tim import get_TOAs_from_tim

    if isinstance(tim, (str, bytes, os.PathLike)):
        toas = get_TOAs_from_tim(tim)
    else:
        toas = tim[:]  # slice-copy: the caller's object stays intact
    _ingest(toas, model)
    _invert_to_integer_phase(toas, model, iterations, device)
    if add_noise:
        _add_white_noise(toas, model, rng)
    return toas


def _make_test_pulsar_toas(par, ntoa, start_mjd, end_mjd, seed, jitter_us,
                           freqs, flags, obs, error_us, iterations, mjds,
                           device):
    """make_test_pulsar's ingested path (the reference's): TOAs at
    ``obs`` through :func:`make_fake_toas_uniform`, receiver flags, white
    jitter, a last ingest."""
    rng = np.random.default_rng(seed)
    model = get_model(par)
    if mjds is not None:
        ntoa = len(mjds)
    toas = make_fake_toas_uniform(
        start_mjd, end_mjd, ntoa, model, error_us=error_us,
        freq_mhz=np.resize(np.asarray(freqs, dtype=np.float64), ntoa),
        obs=obs, iterations=iterations, mjds=mjds, device=device)
    for i, f in enumerate(toas.flags):
        f["f"] = flags[i % len(flags)]
    if jitter_us:
        toas.t = toas.t.add_seconds(rng.normal(0.0, jitter_us * 1e-6, ntoa))
    _ingest(toas, model)
    return model, toas


def make_test_pulsar(par: str, ntoa: int = 64, start_mjd: float = 54000.0,
                     end_mjd: float = 56000.0, seed: int = 0,
                     jitter_us: float = 1.0, freqs=(1400.0, 800.0),
                     flags=("L-wide", "S-wide"), error_us: float = 1.0,
                     iterations: int = 3, orbit: bool = False,
                     orbit_in_phase: bool = False, device=None,
                     dm_error: float | None = None, obs=None, mjds=None):
    """Build (model, toas): the port's model from ``par`` and ``ntoa``
    simulated arrivals.

    With ``obs`` (one code, a per-TOA sequence or a cycling pattern) or
    ``mjds`` (explicit epochs), the reference's path: ingested port
    ``TOAs`` at those sites (``obs`` defaults to '@' then), as
    ``pint_tpu/simulation.py::make_test_pulsar`` builds them.

    Without either, a host TOA table of barycentric arrivals:

    ``orbit=True`` then puts the observatory on a synthetic circular 1-AU
    orbit in the x-y plane with a one-year period, phased from
    ``start_mjd``, exactly as the reference bench does after its
    simulation: the astrometric parameters get leverage, and the
    simulated phases do not include the orbit's Roemer delay.  With
    ``orbit_in_phase=True`` as well, the orbit is in place during the
    inversion, so the simulated arrivals include its delays and the
    model at its par values fits them to the white noise.
    ``dm_error`` (pc cm^-3) makes the TOAs wideband: each TOA's flags
    get ``pp_dme`` = dm_error and a ``pp_dm`` equal to the model's DM
    (``CompiledModel.dm_model`` at the par values) plus N(0, dm_error)
    noise drawn after the timing jitter.
    ``device`` is where the inversion's residual sweeps run."""
    if obs is not None or mjds is not None:
        if orbit or dm_error is not None:
            raise ValueError(
                "orbit and dm_error apply to the barycentric table path "
                "only (no obs=, no mjds=)")
        return _make_test_pulsar_toas(
            par, ntoa, start_mjd, end_mjd, seed, jitter_us, freqs, flags,
            "@" if obs is None else obs, error_us, iterations, mjds,
            device)
    rng = np.random.default_rng(seed)
    model = get_model(par)
    mjds = np.linspace(start_mjd, end_mjd, ntoa)
    freq = np.resize(np.asarray(freqs, dtype=np.float64), ntoa)
    err = np.full(ntoa, error_us)
    mjd_int = np.floor(mjds).astype(np.int64)
    sec = HostDD(mjds - mjd_int) * SECS_PER_DAY
    empty_flags = [dict() for _ in range(ntoa)]

    for _ in range(iterations):
        table = _with_geometry(_table(mjd_int, sec, freq, err, empty_flags),
                               model, orbit and orbit_in_phase, start_mjd)
        cm = model.compile(table, device=device, subtract_mean=False)
        cm.track_mode = "nearest"
        resid = cm.time_residuals(cm.x0(), subtract_mean=False)
        mjd_int, sec = carry_days(mjd_int, sec + (-resid.cpu().numpy()))
    toa_flags = [{"f": flags[i % len(flags)]} for i in range(ntoa)]
    if jitter_us:
        mjd_int, sec = carry_days(
            mjd_int, sec + rng.normal(0.0, jitter_us * 1e-6, ntoa)
        )
    toas = _with_geometry(_table(mjd_int, sec, freq, err, toa_flags),
                          model, orbit, start_mjd)
    if dm_error is not None:
        cm = model.compile(toas, device=device)
        dm = cm.dm_model(cm.x0()).cpu().numpy()
        dm = dm + rng.normal(0.0, dm_error, ntoa)
        for f, v in zip(toa_flags, dm):
            f["pp_dm"] = repr(float(v))
            f["pp_dme"] = repr(float(dm_error))
    return model, toas


def make_population(par: str, npsr: int, ntoa: int = 64, seed: int = 0,
                    spread: float = 1e-9, **make_test_pulsar_kw):
    """``npsr`` variants of one composition sharing one simulated TOA
    set: the base pulsar of :func:`make_test_pulsar`, then copies of its
    model whose free float and double-double parameters are moved by
    ``spread`` relative draws (absolute for zero values) from
    ``default_rng(seed + 0x5EED)``; epochs and pair parameters stay.
    Returns ``(models, toas)``, ``models[0]`` the base model.  The
    reference returns par texts; writing them is the second half of
    ROADMAP A11, so the port returns the models."""
    if npsr < 1:
        raise ValueError(f"make_population needs npsr >= 1, got {npsr}")
    model, toas = make_test_pulsar(par, ntoa=ntoa, seed=seed,
                                   **make_test_pulsar_kw)
    rng = np.random.default_rng(seed + 0x5EED)
    models = [model]
    for _ in range(1, npsr):
        m = get_model(par)
        for name in m.free_params:
            p = m.params[name]
            ref = p.internal()
            if isinstance(ref, HostDD):
                scale = abs(float(ref.hi)) or 1.0
                p.set_internal(ref + spread * scale * rng.standard_normal())
            elif isinstance(ref, float):
                scale = abs(ref) or 1.0
                p.set_internal(ref + spread * scale * rng.standard_normal())
        models.append(m)
    return models, toas


def calculate_random_models(fitter, n_models: int = 100, rng=None):
    """Draw parameter vectors from the fit covariance with the numpy
    ``rng`` and return the residual curves (n_models, ntoa) they give
    (reference: simulation.calculate_random_models).  The residuals of
    every draw are one vmapped evaluation on the fitter's device."""
    rng = rng or np.random.default_rng()
    cov = fitter.parameter_covariance_matrix  # free_names order
    if cov is None:
        raise ValueError("fit first")
    L = np.linalg.cholesky(cov + 1e-30 * np.eye(len(cov)))
    draws = rng.normal(size=(n_models, len(cov))) @ L.T
    cm = fitter.cm
    x = torch.as_tensor(draws, device=cm.device)
    return torch.func.vmap(cm.time_residuals)(x).cpu().numpy()
