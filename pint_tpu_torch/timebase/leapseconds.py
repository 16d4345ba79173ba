"""Leap-second (TAI-UTC) table, 1972+.

Counterpart of ``pint_tpu/timebase/leapseconds.py``.  We embed the
public IERS announcements as (calendar date, TAI-UTC) and derive MJDs from
``datetime`` (no hand-typed day numbers).  The table is complete through
2017-01-01 (TAI-UTC = 37 s); no leap second has been announced since.  An
updated table can be loaded from a standard ``leap-seconds.list`` file via
:func:`load_leap_seconds_list`.

Pre-1972 ("rubber second") epochs are out of scope, matching the practical
domain of pulsar-timing data; conversions before MJD 41317 raise.
"""

from __future__ import annotations

from datetime import date

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError

_MJD_EPOCH_ORDINAL = date(1858, 11, 17).toordinal()


def calendar_to_mjd(year: int, month: int, day: int) -> int:
    return date(year, month, day).toordinal() - _MJD_EPOCH_ORDINAL


# (effective date, TAI-UTC seconds) — IERS Bulletin C history.
_LEAP_HISTORY = [
    ((1972, 1, 1), 10),
    ((1972, 7, 1), 11),
    ((1973, 1, 1), 12),
    ((1974, 1, 1), 13),
    ((1975, 1, 1), 14),
    ((1976, 1, 1), 15),
    ((1977, 1, 1), 16),
    ((1978, 1, 1), 17),
    ((1979, 1, 1), 18),
    ((1980, 1, 1), 19),
    ((1981, 7, 1), 20),
    ((1982, 7, 1), 21),
    ((1983, 7, 1), 22),
    ((1985, 7, 1), 23),
    ((1988, 1, 1), 24),
    ((1990, 1, 1), 25),
    ((1991, 1, 1), 26),
    ((1992, 7, 1), 27),
    ((1993, 7, 1), 28),
    ((1994, 7, 1), 29),
    ((1996, 1, 1), 30),
    ((1997, 7, 1), 31),
    ((1999, 1, 1), 32),
    ((2006, 1, 1), 33),
    ((2009, 1, 1), 34),
    ((2012, 7, 1), 35),
    ((2015, 7, 1), 36),
    ((2017, 1, 1), 37),
]

_LEAP_MJDS = [calendar_to_mjd(*d) for d, _ in _LEAP_HISTORY]
_LEAP_OFFSETS = [off for _, off in _LEAP_HISTORY]


def load_leap_seconds_list(path) -> None:
    """Extend/replace the table from an NTP ``leap-seconds.list`` file
    (lines: NTP-epoch-seconds TAI-UTC).  NTP epoch 1900-01-01 = MJD 15020."""
    global _LEAP_MJDS, _LEAP_OFFSETS
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ntp_sec, off = int(parts[0]), int(parts[1])
            mjd = 15020 + ntp_sec // 86400
            entries.append((mjd, off))
    entries.sort()
    if entries:
        _LEAP_MJDS = [e[0] for e in entries]
        _LEAP_OFFSETS = [e[1] for e in entries]


def tai_minus_utc(mjd_utc) -> np.ndarray:
    """TAI-UTC in integer seconds at the given UTC MJD(s) (1972+)."""
    mjd = np.atleast_1d(np.asarray(mjd_utc, dtype=np.int64))
    if np.any(mjd < _LEAP_MJDS[0]):
        raise PintTpuError(
            f"UTC before MJD {_LEAP_MJDS[0]} (1972-01-01) unsupported"
        )
    idx = np.searchsorted(_LEAP_MJDS, mjd, side="right") - 1
    out = np.asarray(_LEAP_OFFSETS, dtype=np.int64)[idx]
    return out if np.ndim(mjd_utc) else out[0]


def is_leap_second_day(mjd_utc) -> np.ndarray:
    """True where UTC day mjd has 86401 seconds (day before a step)."""
    mjd = np.atleast_1d(np.asarray(mjd_utc, dtype=np.int64))
    out = np.isin(mjd + 1, np.asarray(_LEAP_MJDS))
    return out if np.ndim(mjd_utc) else out[0]


def leap_second_table():
    """(mjd array, TAI-UTC array) — for inspection/serialization."""
    return np.asarray(_LEAP_MJDS), np.asarray(_LEAP_OFFSETS)
