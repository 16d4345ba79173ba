"""Host (numpy) double-double values for load-time code.

Counterpart of ``pint_tpu/timebase/hostdd.py``: exact decimal-string
parsing of par-file and tim-file values, and the add/multiply/divide/
normalize arithmetic that epoch commits, the simulation's arrival-time
shifts and the ingest's time-scale chain run on the host.  numpy
guarantees IEEE f64 with no contraction, so these transforms are exact.
"""

from __future__ import annotations

from decimal import Decimal, localcontext

import numpy as np

_SPLITTER = 134217729.0  # 2**27 + 1


def parse_decimal(s: str) -> tuple[float, float]:
    """Exact decimal string -> (hi, lo) with hi + lo the nearest DD."""
    with localcontext() as ctx:
        ctx.prec = 50
        d = Decimal(s)
        hi = float(d)
        lo = float(d - Decimal(hi))
    return hi, lo


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


def _two_prod(a, b):
    p = a * b
    t = _SPLITTER * a
    ahi = t - (t - a)
    alo = a - ahi
    t = _SPLITTER * b
    bhi = t - (t - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


class HostDD:
    """value = hi + lo, numpy f64 arrays (or scalars)."""

    __slots__ = ("hi", "lo")
    __array_priority__ = 100  # beat ndarray in mixed binary ops

    def __init__(self, hi, lo=None):
        self.hi = np.asarray(hi, dtype=np.float64)
        self.lo = (
            np.zeros_like(self.hi) if lo is None
            else np.asarray(lo, dtype=np.float64)
        )

    @staticmethod
    def from_sum(a, b) -> "HostDD":
        """a + b exactly (a, b f64)."""
        return HostDD(*_two_sum(np.asarray(a, dtype=np.float64),
                                np.asarray(b, dtype=np.float64)))

    @staticmethod
    def from_string(s) -> "HostDD":
        """Exact decimal-string parse; ``s`` a str or a sequence of str."""
        if isinstance(s, str):
            return HostDD(*parse_decimal(s))
        pairs = [parse_decimal(x) for x in s]
        return HostDD(np.array([p[0] for p in pairs]),
                      np.array([p[1] for p in pairs]))

    @staticmethod
    def from_prod(a, b) -> "HostDD":
        """a * b exactly (a, b f64)."""
        return HostDD(*_two_prod(np.asarray(a, dtype=np.float64),
                                 np.asarray(b, dtype=np.float64)))

    def normalize(self) -> "HostDD":
        return HostDD(*_quick_two_sum(self.hi, self.lo))

    def _coerce(self, other) -> "HostDD":
        return other if isinstance(other, HostDD) else HostDD(other)

    def __add__(self, other):
        other = self._coerce(other)
        s, e = _two_sum(self.hi, other.hi)
        e = e + (self.lo + other.lo)
        return HostDD(*_quick_two_sum(s, e))

    __radd__ = __add__

    def __neg__(self):
        return HostDD(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __mul__(self, other):
        other = self._coerce(other)
        p, e = _two_prod(self.hi, other.hi)
        e = e + (self.hi * other.lo + self.lo * other.hi)
        return HostDD(*_quick_two_sum(p, e))

    __rmul__ = __mul__

    def __truediv__(self, other):
        other = self._coerce(other)
        q1 = self.hi / other.hi
        r = self - other * q1
        q2 = r.hi / other.hi
        r = r - other * q2
        q3 = r.hi / other.hi
        s, e = _quick_two_sum(q1, q2)
        return HostDD(*_quick_two_sum(s, e + q3))

    def to_float(self):
        return self.hi + self.lo

    def __float__(self):
        return float(self.hi + self.lo)

    @property
    def shape(self):
        return self.hi.shape

    def __len__(self):
        return len(self.hi)

    def __getitem__(self, idx):
        return HostDD(self.hi[idx], self.lo[idx])

    def __repr__(self):
        return f"HostDD(hi={self.hi!r}, lo={self.lo!r})"


def carry_days(mjd_int, sec: HostDD, day_len: float = 86400.0):
    """Carry seconds into days so 0 <= sec < day_len (uniform-day scales)."""
    carry = np.floor(sec.hi / day_len)
    sec = sec - carry * day_len
    neg = sec.hi < 0  # boundary cases from the f64 floor
    sec = HostDD(np.where(neg, sec.hi + day_len, sec.hi), sec.lo).normalize()
    carry = carry - neg
    over = sec.hi >= day_len
    sec = HostDD(np.where(over, sec.hi - day_len, sec.hi), sec.lo).normalize()
    carry = carry + over
    return mjd_int + carry.astype(np.int64), sec
