"""Orbital longitude from PB/PBDOT or FBn, with DD orbit counting.

Counterpart of ``pint_tpu/models/binaries/orbits.py``: dt spans ~1e9 s
and PB ~1e4-1e6 s, so the orbit count reaches ~1e5 (3000 orbits over 12
years at PB = 1.5 d).  It is formed in double-double and split into its
integer and fractional parts by ``DD.split_int_frac``, so the orbital
phase the kernels take is exact to ~1e-16 of an orbit; an f64 count
would cost nanoseconds of Roemer delay.
"""

from __future__ import annotations

import math

from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.ops.taylor import taylor_horner_dd, taylor_horner_deriv

TWOPI = 2.0 * math.pi


def to_f64(v):
    """An f64 value of a parameter that may be a DD."""
    return v.to_float() if isinstance(v, DD) else v


def orbits_pb(dt: DD, pb, pbdot=0.0, xpbdot=0.0) -> DD:
    """Orbits since the epoch: dt/PB - (PBDOT + XPBDOT)/2 (dt/PB)^2; pb
    may be DD."""
    nbdt = dt / pb
    corr = to_f64(pbdot + xpbdot)
    return nbdt - (nbdt * nbdt) * (0.5 * corr)


def orbits_fb(dt: DD, fbs) -> DD:
    """Orbits from the orbital-frequency series FB0, FB1, ...:
    sum_i FBi dt^(i+1) / (i+1)!."""
    return taylor_horner_dd(dt, [0.0, *fbs])


def phase_from_orbits(orbits: DD):
    """-> (phi, norbit): orbital longitude 2 pi frac in [-pi, pi) and the
    integer orbit count (f64)."""
    norbit, frac = orbits.split_int_frac()
    return TWOPI * frac, norbit


def nb_pb(dt_f, pb, pbdot=0.0, xpbdot=0.0):
    """Instantaneous orbital angular frequency 2 pi d(orbits)/dt, f64."""
    pb = to_f64(pb)
    corr = to_f64(pbdot + xpbdot)
    return TWOPI * (1.0 / pb - corr * dt_f / (pb * pb))


def nb_fb(dt_f, fbs):
    return TWOPI * taylor_horner_deriv(dt_f, [0.0, *[to_f64(f) for f in fbs]],
                                       1)
