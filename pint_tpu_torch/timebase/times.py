"""TimeArray: integer MJD + double-double seconds-of-day, scale-tagged.

Counterpart of ``pint_tpu/timebase/times.py``.  The day number is exact
(int64); time-of-day is HostDD seconds (~1e-28 s resolution);
conversions between UTC/TAI/TT/TDB/TCB/TCG keep everything in exact + DD
arithmetic, so round-trips hold to ~1e-20 s.

MJD string parsing supports both conventions:
- ``format="pulsar_mjd"`` (Tempo/Princeton convention, the reference's
  default for tim files): fractional day * 86400 s even on leap-second
  days — i.e. the label is interpreted as if every UTC day had 86400 s.
- ``format="mjd"``: true elapsed-seconds interpretation (a leap-second
  day has 86401 s, so frac .99999 can land inside the leap second).
Both agree except during/after a leap second within a day.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

from pint_tpu_torch.constants import (
    L_B,
    L_G,
    MJD_J2000,
    SECS_PER_DAY,
    TDB0,
    TT_MINUS_TAI,
)
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.timebase.hostdd import HostDD, carry_days
from pint_tpu_torch.timebase.leapseconds import (
    is_leap_second_day,
    tai_minus_utc,
)
from pint_tpu_torch.timebase.scales import tcb_to_tdb
from pint_tpu_torch.timebase.tdb import tdb_minus_tt

SCALES = ("utc", "tai", "tt", "tdb", "tcg", "tcb", "ut1")

# MJD(TT) of 1977-01-01T00:00:32.184 TT == JD 2443144.5003725, the shared
# origin epoch of TT/TCG/TCB rate transforms (IAU 1991/2000/2006).
_T77_MJD = 43144.0
_T77_SEC = 32.184


# The conversion graph is a chain (tcg hangs off tt):
#   utc -- tai -- tt -- tdb -- tcb        tt -- tcg
_CHAIN = ["utc", "tai", "tt", "tdb", "tcb"]

# first MJD of the leap-second era (1972-01-01, TAI-UTC = 10 s)
_LEAP_GUARD = 41317


def _route(src: str, dst: str) -> list[str]:
    """Sequence of intermediate scales (excluding src) from src to dst."""
    for s in (src, dst):
        if s == "ut1":
            raise PintTpuError(
                "ut1 conversions require an EOP table "
                "(earth/eop.py); not available on this TimeArray"
            )

    def chain_pos(s):
        return _CHAIN.index(s if s != "tcg" else "tt")

    route = []
    if src == "tcg":
        route.append("tt")
        src = "tt"
    i, j = chain_pos(src), _CHAIN.index(dst if dst != "tcg" else "tt")
    if i != j:
        step = 1 if j > i else -1
        stop = j + step if j + step >= 0 else None
        route += _CHAIN[i + step : stop : step]
    if dst == "tcg":
        route.append("tcg")
    return route


class TimeArray:
    """An array of epochs: ``mjd_int`` (int64 days) + ``sec`` (HostDD
    seconds-of-day) in time scale ``scale``."""

    __slots__ = ("mjd_int", "sec", "scale")

    def __init__(self, mjd_int, sec: HostDD, scale: str = "utc"):
        if scale not in SCALES:
            raise PintTpuError(f"unknown time scale {scale!r}")
        self.mjd_int = np.atleast_1d(np.asarray(mjd_int, dtype=np.int64))
        sec = sec if isinstance(sec, HostDD) else HostDD(sec)
        self.sec = HostDD(
            np.broadcast_to(np.atleast_1d(sec.hi), self.mjd_int.shape).copy(),
            np.broadcast_to(np.atleast_1d(sec.lo), self.mjd_int.shape).copy(),
        )
        self.scale = scale

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_mjd_strings(
        strings: Union[str, Iterable[str]],
        scale: str = "utc",
        format: str = "pulsar_mjd",
    ) -> "TimeArray":
        """Exact parse of decimal MJD strings (tim-file convention)."""
        if isinstance(strings, str):
            strings = [strings]
        strings = list(strings)
        if format not in ("pulsar_mjd", "mjd"):
            raise PintTpuError(f"unknown MJD format {format!r}")
        if format == "pulsar_mjd" or scale != "utc":
            # native batched parse (C++ double-double); identical
            # convention: fraction of an 86400 s day.  Errors are
            # normalized to PintTpuError so callers see the same
            # exception type with or without the native library.
            from pint_tpu_torch import native

            try:
                parsed = native.parse_mjd_strings(strings)
            except ValueError as e:
                raise PintTpuError(str(e)) from e
            if parsed is not None:
                day, hi, lo = parsed
                return TimeArray(day, HostDD(hi, lo), scale)
        ints, fracs = [], []
        for s in strings:
            s = s.strip()
            neg = s.startswith("-")
            if neg:
                raise PintTpuError(f"negative MJD not supported: {s}")
            ipart, _, fpart = s.partition(".")
            ints.append(int(ipart))
            fracs.append("0." + (fpart or "0"))
        mjd_int = np.array(ints, dtype=np.int64)
        frac = HostDD.from_string(fracs)
        if format == "mjd" and scale == "utc":
            day_len = np.where(
                is_leap_second_day(mjd_int), SECS_PER_DAY + 1, SECS_PER_DAY
            )
            sec = frac * day_len
        else:  # pulsar_mjd convention, or uniform-day (non-UTC) scales
            sec = frac * SECS_PER_DAY
        return TimeArray(mjd_int, sec, scale)

    @staticmethod
    def from_mjd_two_part(day, sec_of_day, scale: str = "tdb") -> "TimeArray":
        """From integer MJD days and float seconds of day."""
        return TimeArray(day, HostDD(sec_of_day), scale)

    @staticmethod
    def from_mjd_float(mjd, scale: str = "tdb") -> "TimeArray":
        """From float64 MJD (sub-µs resolution only — for tests/sim)."""
        mjd = np.atleast_1d(np.asarray(mjd, dtype=np.float64))
        mjd_int = np.floor(mjd).astype(np.int64)
        sec = HostDD(mjd - mjd_int) * SECS_PER_DAY
        return TimeArray(mjd_int, sec, scale)

    # ------------------------------------------------------------------ #
    def to_mjd_strings(self, ndigits: int = 19) -> list[str]:
        """Decimal MJD strings (pulsar_mjd convention), round-trip safe.

        Limitation inherited from the pulsar_mjd format itself: an
        instant *inside* a leap second (sec-of-day >= 86400) has no
        representation; such values raise rather than silently shifting
        into the next day.
        """
        from decimal import Decimal, localcontext

        if self.scale == "utc" and np.any(self.sec.hi >= SECS_PER_DAY):
            raise PintTpuError(
                "cannot serialize an instant inside a leap second in "
                "pulsar_mjd format; convert to a uniform scale first"
            )
        out = []
        for i in range(len(self.mjd_int)):
            with localcontext() as ctx:
                ctx.prec = 40
                frac = (
                    Decimal(float(self.sec.hi[i])) + Decimal(float(self.sec.lo[i]))
                ) / Decimal(86400)
                total = Decimal(int(self.mjd_int[i])) + frac
                out.append(f"{total:.{ndigits}f}")
        return out

    def mjd_float(self) -> np.ndarray:
        """Approximate float64 MJD (for plotting/selection, ~µs)."""
        return self.mjd_int + self.sec.to_float() / SECS_PER_DAY

    def mjd_dd(self) -> HostDD:
        """MJD as HostDD days."""
        return HostDD(self.mjd_int.astype(np.float64)) + self.sec / SECS_PER_DAY

    def seconds_since(self, epoch_mjd_int, epoch_sec=0.0) -> HostDD:
        """(self - epoch) in DD seconds; exact day-difference arithmetic."""
        ddays = (self.mjd_int - np.int64(epoch_mjd_int)).astype(np.float64)
        return HostDD.from_prod(ddays, SECS_PER_DAY) + (self.sec - epoch_sec)

    # ------------------------------------------------------------------ #
    # scale conversions
    def to_scale(self, target: str) -> "TimeArray":
        if target == self.scale:
            return self
        t = self
        for hop in _route(self.scale, target):
            t = t._one_hop(hop)
        return t

    def _one_hop(self, target: str) -> "TimeArray":
        key = (self.scale, target)
        if key == ("utc", "tai"):
            return self._utc_to_tai()
        if key == ("tai", "utc"):
            return self._tai_to_utc()
        if key == ("tai", "tt"):
            return self._shift_const(TT_MINUS_TAI, "tt")
        if key == ("tt", "tai"):
            return self._shift_const(-TT_MINUS_TAI, "tai")
        if key == ("tt", "tdb"):
            return self._tt_to_tdb()
        if key == ("tdb", "tt"):
            return self._tdb_to_tt()
        if key == ("tt", "tcg"):
            return self._tt_to_tcg()
        if key == ("tcg", "tt"):
            return self._tcg_to_tt()
        if key == ("tdb", "tcb"):
            return self._tdb_to_tcb()
        if key == ("tcb", "tdb"):
            return self._tcb_to_tdb()
        raise PintTpuError(f"no conversion {key}")

    def _shift_const(self, dt_sec: float, scale: str) -> "TimeArray":
        mjd, sec = carry_days(self.mjd_int, self.sec + dt_sec)
        return TimeArray(mjd, sec, scale)

    def _utc_to_tai(self) -> "TimeArray":
        off = tai_minus_utc(self.mjd_int).astype(np.float64)
        mjd, sec = carry_days(self.mjd_int, self.sec + off)
        return TimeArray(mjd, sec, "tai")

    def _tai_to_utc(self) -> "TimeArray":
        # UTC day D starts at TAI-elapsed T_start(D) = (D-E)*86400+off(D)
        # (E = 41317, where TAI-UTC = 10 s).  Find the largest D with
        # T_start(D) <= T; then sec = T - T_start(D), which lands in
        # [86400, 86401) during a leap second — round-tripping exactly
        # through _utc_to_tai.
        E = _LEAP_GUARD
        T = self.seconds_since(E)  # DD TAI-elapsed
        q = np.floor(T.hi / SECS_PER_DAY).astype(np.int64)
        d0 = E + q
        off0 = tai_minus_utc(d0).astype(np.float64)
        # sec-of-day candidate for D = d0
        s0 = T - HostDD.from_prod(q.astype(np.float64), SECS_PER_DAY)
        in_prev = s0.hi < off0  # T before d0's start: belongs to d0-1
        d = np.where(in_prev, d0 - 1, d0)
        off = tai_minus_utc(d).astype(np.float64)
        sec = (
            s0
            + np.where(in_prev, SECS_PER_DAY, 0.0)
            - off
        ).normalize()
        return TimeArray(d, sec, "utc")

    def _tt_centuries(self) -> np.ndarray:
        return (
            (self.mjd_int - MJD_J2000) + self.sec.to_float() / SECS_PER_DAY
        ) / 36525.0

    def _tt_to_tdb(self) -> "TimeArray":
        d = tdb_minus_tt(self._tt_centuries())
        mjd, sec = carry_days(self.mjd_int, self.sec + d)
        return TimeArray(mjd, sec, "tdb")

    def _tdb_to_tt(self) -> "TimeArray":
        # TDB-TT argument uses TT; one fixed-point pass is plenty (the
        # series slope is ~2e-8 s/s)
        d = tdb_minus_tt(self._tt_centuries())
        mjd, sec = carry_days(self.mjd_int, self.sec - d)
        t1 = TimeArray(mjd, sec, "tt")
        d2 = tdb_minus_tt(t1._tt_centuries())
        mjd, sec = carry_days(self.mjd_int, self.sec - d2)
        return TimeArray(mjd, sec, "tt")

    def _elapsed_since_t77(self) -> HostDD:
        return self.seconds_since(int(_T77_MJD), _T77_SEC)

    def _tt_to_tcg(self) -> "TimeArray":
        # TCG - TT = LG/(1-LG) * (TT - T77)
        rate = L_G / (1.0 - L_G)
        d = self._elapsed_since_t77() * rate
        mjd, sec = carry_days(self.mjd_int, self.sec + d)
        return TimeArray(mjd, sec, "tcg")

    def _tcg_to_tt(self) -> "TimeArray":
        d = self._elapsed_since_t77() * L_G
        mjd, sec = carry_days(self.mjd_int, self.sec - d)
        return TimeArray(mjd, sec, "tt")

    def _tdb_to_tcb(self) -> "TimeArray":
        # TDB = TCB - LB*(TCB - T77) + TDB0  =>  invert
        d = (self._elapsed_since_t77() - TDB0) * (L_B / (1.0 - L_B))
        mjd, sec = carry_days(self.mjd_int, self.sec + d - TDB0)
        return TimeArray(mjd, sec, "tcb")

    def _tcb_to_tdb(self) -> "TimeArray":
        mjd, sec = tcb_to_tdb(self.mjd_int, self.sec)
        return TimeArray(mjd, sec, "tdb")

    # ------------------------------------------------------------------ #
    @property
    def shape(self):
        return self.mjd_int.shape

    def __len__(self):
        return len(self.mjd_int)

    def __getitem__(self, idx) -> "TimeArray":
        return TimeArray(self.mjd_int[idx], self.sec[idx], self.scale)

    def __repr__(self):
        n = len(self.mjd_int)
        head = ", ".join(self[: min(n, 3)].to_mjd_strings(10))
        return f"TimeArray<{self.scale}>[{n}]({head}{'...' if n > 3 else ''})"

    def add_seconds(self, s) -> "TimeArray":
        """Shift by s seconds (float/array/HostDD), carrying days."""
        mjd, sec = carry_days(self.mjd_int, self.sec + s)
        return TimeArray(mjd, sec, self.scale)

    def sort_index(self) -> np.ndarray:
        # lexsort: primary key last; exact ordering even at sub-ns spacing
        return np.lexsort((self.sec.lo, self.sec.hi, self.mjd_int))
