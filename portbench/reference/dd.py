"""Double-double arithmetic on numpy arrays, for the plain reference.

A value is a pair (hi, lo) of float64 arrays with |lo| <= ulp(hi) / 2,
so it carries about 106 bits: the spin phase of a millisecond pulsar
(~5e10 cycles over 12 years) keeps ~1e-21 of a cycle.  The error-free
transformations are Knuth's two-sum and Dekker's split product; nothing
here depends on a fused multiply-add or an extended-precision type.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

_SPLIT = 134217729.0  # 2**27 + 1


def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


class DD:
    """A double-double array (or scalar)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=0.0):
        self.hi = np.asarray(hi, dtype=np.float64)
        self.lo = np.asarray(lo, dtype=np.float64) + np.zeros_like(self.hi)

    @staticmethod
    def from_fraction(q: Fraction) -> "DD":
        hi = float(q)
        return DD(hi, float(q - Fraction(hi)))

    def to_float(self):
        return self.hi + self.lo

    def _norm(self, s, e) -> "DD":
        return DD(*fast_two_sum(s, e))

    def __add__(self, other) -> "DD":
        if not isinstance(other, DD):
            s, e = two_sum(self.hi, np.asarray(other, np.float64))
            return self._norm(s, e + self.lo)
        s, e = two_sum(self.hi, other.hi)
        return self._norm(s, e + (self.lo + other.lo))

    __radd__ = __add__

    def __neg__(self) -> "DD":
        return DD(-self.hi, -self.lo)

    def __sub__(self, other) -> "DD":
        return self + (-other)

    def __rsub__(self, other) -> "DD":
        return (-self) + other

    def __mul__(self, other) -> "DD":
        if not isinstance(other, DD):
            other = np.asarray(other, np.float64)
            p, e = two_prod(self.hi, other)
            return self._norm(p, e + self.lo * other)
        p, e = two_prod(self.hi, other.hi)
        return self._norm(p, e + (self.hi * other.lo + self.lo * other.hi))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "DD":
        if not isinstance(other, DD):
            other = DD(other)
        q1 = self.hi / other.hi
        r = self - other * q1
        q2 = r.hi / other.hi
        r = r - other * q2
        q3 = r.hi / other.hi
        return DD(*fast_two_sum(q1, q2)) + q3

    def nearest_frac(self):
        """(integer part, fractional part in [-0.5, 0.5)) as float64:
        the phase of the nearest pulse."""
        n = np.floor(self.hi + 0.5)
        rem = DD(self.hi - n, self.lo)  # hi - n is exact
        m = np.floor(rem.hi + rem.lo + 0.5)
        return n + m, (rem.hi - m) + rem.lo

    def __getitem__(self, idx) -> "DD":
        return DD(self.hi[idx], self.lo[idx])


def epoch_seconds(day, sec: DD, epoch_day: int, epoch_sec: DD) -> DD:
    """(day, sec) - (epoch_day, epoch_sec) in seconds, as a double-double:
    the day difference times 86400 is exact in float64."""
    return (sec - epoch_sec) + (np.asarray(day, np.float64)
                                - float(epoch_day)) * 86400.0
