"""The benchmark's TOA simulator and the cells' starting models.

``simulate(config, seed)`` writes the configuration's par text (the
truth), lays out its arrival times, frequencies and receiver flags, puts
the observatory on a synthetic circular 1-AU orbit in the x-y plane with
a one-year period (the Sun at the barycentre), and shifts each arrival
until the reference model's phase is an integer.  It then adds the noise
the model states, drawn from ``--seed``: white noise of the scaled
sigma, one ECORR offset per observing epoch and receiver, and the
power-law red noise's harmonics.  ``start_par`` offsets the free
parameters of the truth by a seeded draw of the cell's scales.  The
program and the reference are both handed the same table and par text.
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext

import numpy as np

from portbench.inputs import pars
from portbench.reference.dd import DD
from portbench.reference.model import AU_LIGHT_SEC, ReferenceModel
from portbench.reference.parfile import read_par

SECS_PER_DAY = 86400.0
#: passes of the integer-phase inversion (each gains ~1e-4, the orbit's
#: rate, on the last)
INVERT_PASSES = 3


def layout(toas: dict):
    """(arrival MJDs (float64), frequencies (MHz), flags) of a
    configuration's ``toas`` section."""
    if toas["layout"] == "uniform":
        mjds = np.linspace(*toas["span"], toas["ntoa"])
    elif toas["layout"] == "epochs":
        mjds = pars.epoch_mjds(toas["nepoch"], toas["per_epoch"],
                               *toas["span"], toas.get("spacing_s", 1.0))
    else:
        raise ValueError(f"unknown TOA layout {toas['layout']!r}")
    n = len(mjds)
    freqs = np.resize(np.asarray(getattr(pars, toas["freqs"]), np.float64),
                      n)
    flags = [{"f": toas["flags"][i % len(toas["flags"])]} for i in range(n)]
    return mjds, freqs, flags


def _carry(day, sec: DD):
    """Whole days out of the seconds, so 0 <= sec < 86400."""
    k = np.floor(sec.hi / SECS_PER_DAY)
    return day + k, sec - k * SECS_PER_DAY


def _table(day, sec: DD, freqs, error_us, flags, start_mjd):
    ph = 2.0 * math.pi * (day + sec.to_float() / SECS_PER_DAY
                          - start_mjd) / 365.25
    pos = AU_LIGHT_SEC * np.stack([np.cos(ph), np.sin(ph),
                                   np.zeros_like(ph)], axis=-1)
    n = len(freqs)
    return {
        "tdb_day": day.copy(),
        "tdb_sec_hi": sec.hi.copy(),
        "tdb_sec_lo": sec.lo.copy(),
        "freq_mhz": freqs,
        "error_us": np.full(n, error_us),
        "pulse_number": np.full(n, np.nan),
        "padd": np.zeros(n),
        "flags": flags,
        "ssb_obs_pos_ls": pos,
        "obs_sun_pos_ls": -pos,
    }


def truth_par(config: dict) -> str:
    """The configuration's par text from its writer, with the fit flag of
    each parameter it lists under ``frozen`` cleared."""
    spec = config["par"]
    text = getattr(pars, spec["writer"])(**spec.get("args", {}))
    frozen = set(spec.get("frozen", []))
    out = []
    for line in text.splitlines():
        tok = line.split()
        if tok and tok[0] in frozen and tok[-1] == "1":
            line = " ".join(tok[:-1])
        out.append(line)
    return "\n".join(out) + "\n"


def simulate(config: dict, seed: int):
    """(truth par text, TOA table) of a configuration for ``seed``."""
    par = truth_par(config)
    toas = config["toas"]
    mjds, freqs, flags = layout(toas)
    day = np.floor(mjds)
    sec = DD(mjds - day) * SECS_PER_DAY
    start = toas["span"][0]
    err = toas.get("error_us", 1.0)
    nfree = len(read_par(par).free)
    for _ in range(INVERT_PASSES):
        model = ReferenceModel(par, _table(day, sec, freqs, err, flags,
                                           start))
        day, sec = _carry(day, sec - model.residuals(np.zeros(nfree)))
    sigma, T, phi = model.noise()
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, 1.0, len(mjds)) * sigma
    noise += T @ (rng.normal(0.0, 1.0, len(phi)) * np.sqrt(phi))
    day, sec = _carry(day, sec + noise)
    return par, _table(day, sec, freqs, err, flags, start)


def start_par(par: str, offsets: dict, seed: int) -> str:
    """The cell's starting model: each free parameter's value moved by
    scale x N(0, 1), the scale (in par units) from ``offsets`` by the
    line's name or, failing that, by its name less trailing digits (a
    DMX family); draws from a stream of ``seed`` apart from the noise's.
    The values are written as exact decimals, so both sides read one
    number."""
    rng = np.random.default_rng([seed, 0x5747])
    out = []
    with localcontext() as ctx:
        ctx.prec = 34
        for line in par.splitlines():
            tok = line.split()
            vi = 3 if len(tok) > 1 and tok[1].startswith("-") else 1
            if len(tok) > vi + 1 and tok[vi + 1] == "1":
                name = tok[0]
                scale = offsets.get(name,
                                    offsets.get(name.rstrip("0123456789")))
                if scale is None:
                    raise KeyError(f"no start offset for free {name}")
                z = Decimal(repr(float(rng.standard_normal())))
                tok[vi] = str(Decimal(tok[vi]) + Decimal(str(scale)) * z)
                line = " ".join(tok)
            out.append(line)
    return "\n".join(out) + "\n"
