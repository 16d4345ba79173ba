"""Frozen copies of the par writers and TOA layouts the configurations use.

Copied from ``pint_tpu_torch/simulation.py`` (``MSP_FREQS``, ``MSP_SPAN``,
``msp_par``, ``NANOGRAV_FREQS``, ``epoch_mjds``, ``b1855_par``) so that a
change to the program cannot change the benchmark's inputs.  The
configuration files name these writers and their arguments.
"""

from __future__ import annotations

import numpy as np

SECS_PER_DAY = 86400.0

#: the binary MSP's observing frequencies (MHz), cycled over the TOAs
#: while the receiver flags cycle over (L-wide, S-wide): every frequency
#: meets both receivers, so FD, JUMP and DMX are not degenerate
MSP_FREQS = (820.0, 1150.0, 1400.0, 1700.0, 2300.0)
#: the span the DMX ranges cover (MJD), that of the simulations
MSP_SPAN = (53000.0, 57500.0)


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


#: NANOGrav-style sub-band frequencies (MHz), cycled over the TOAs while
#: the receiver flags alternate (L-wide, S-wide): the even TOAs get the
#: four L-wide channels, the odd ones the four S-wide channels
NANOGRAV_FREQS = (1180.0, 1800.0, 1340.0, 2000.0, 1500.0, 2200.0, 1660.0,
                  2400.0)
def epoch_mjds(nepoch: int, per_epoch: int, start_mjd: float,
               end_mjd: float, spacing_s: float = 1.0) -> np.ndarray:
    """Observing epochs: ``nepoch`` sessions evenly spread over
    [start_mjd, end_mjd], each of ``per_epoch`` TOAs ``spacing_s`` apart.
    With the receiver flags alternating TOA by TOA, each receiver's TOAs
    of a session are 2 x spacing_s apart, inside one ECORR epoch
    (``models/noise.py::ECORR_EPOCH_GAP_S``)."""
    starts = np.linspace(start_mjd, end_mjd - per_epoch * spacing_s
                         / SECS_PER_DAY, nepoch)
    steps = np.arange(per_epoch) * spacing_s / SECS_PER_DAY
    return (starts[:, None] + steps[None, :]).reshape(-1)


def b1855_par(ndmx: int = 100, seed: int = 0) -> str:
    """Par text of the reference's BASELINE config 3 (B1855+09 with
    power-law red noise and ECORR, a correlated-noise GLS fit):
    :func:`msp_par` with ECORR on both receivers.  Free: msp_par's (117
    at 100 ranges; 118 design columns with the offset)."""
    return msp_par(ndmx, seed) + "ECORR -f L-wide 0.4\nECORR -f S-wide 0.25\n"
