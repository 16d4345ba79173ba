"""TCB -> TDB epoch conversion on the host, in double-double.

Counterpart of ``pint_tpu/timebase/times.py``'s ``_tcb_to_tdb`` (IAU 2006
Resolution B3), cut to the one hop a par file's ``UNITS TCB`` needs.  An epoch is an exact integer MJD plus HostDD seconds
of day; the arithmetic is the reference's step for step, so a converted
epoch equals the reference's bit for bit as hi and lo.

  TDB = TCB - L_B (TCB - T77) + TDB0,   T77 = MJD 43144 + 32.184 s
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import L_B, SECS_PER_DAY, TDB0
from pint_tpu_torch.timebase.hostdd import HostDD, carry_days

# MJD(TT) of 1977-01-01T00:00:32.184 TT, the origin of the rate transforms
_T77_MJD = 43144
_T77_SEC = 32.184


def _seconds_since_t77(mjd_int, sec: HostDD) -> HostDD:
    ddays = (mjd_int - np.int64(_T77_MJD)).astype(np.float64)
    return HostDD.from_prod(ddays, SECS_PER_DAY) + (sec - _T77_SEC)


def tcb_to_tdb(mjd_int, sec: HostDD):
    """(mjd_int (n,) int64, sec HostDD (n,)) in TCB -> the same in TDB."""
    mjd_int = np.asarray(mjd_int, dtype=np.int64)
    d = _seconds_since_t77(mjd_int, sec) * L_B
    return carry_days(mjd_int, sec - d + TDB0)
