"""Earth-orientation parameters (UT1-UTC, polar motion).

Counterpart of ``pint_tpu/earth/eop.py``.  Offline-first: a parser for
the standard IERS ``finals2000A.all`` fixed-width format, loaded from
``$PINT_TPU_EOP`` or an explicit path; with no table, DUT1 = xp = yp = 0
with a one-time warning (absolute timing error bounded by |DUT1| <= 0.9 s
x 465 m/s / c ~= 1.4 us of Roemer; polar motion < 15 m ~= 50 ns).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

ARCSEC = np.pi / (180.0 * 3600.0)

_warned = False


class EOPTable:
    def __init__(self, mjd, dut1_s, xp_rad, yp_rad, name="eop"):
        order = np.argsort(mjd)
        self.mjd = np.asarray(mjd, float)[order]
        self.dut1_s = np.asarray(dut1_s, float)[order]
        self.xp_rad = np.asarray(xp_rad, float)[order]
        self.yp_rad = np.asarray(yp_rad, float)[order]
        self.name = name

    def at(self, mjd_utc):
        """(dut1_s, xp_rad, yp_rad) linearly interpolated; clamped at the
        table ends."""
        m = np.asarray(mjd_utc, float)
        return (
            np.interp(m, self.mjd, self.dut1_s),
            np.interp(m, self.mjd, self.xp_rad),
            np.interp(m, self.mjd, self.yp_rad),
        )


def parse_finals2000a(path) -> EOPTable:
    """Parse the IERS finals2000A.all fixed-width format.

    Columns (1-indexed): MJD 8-15, PM-x 19-27 ("), PM-y 38-46 ("),
    UT1-UTC 59-68 (s).  Rows without a UT1 value are skipped.
    """
    mjds, duts, xps, yps = [], [], [], []
    with open(path) as f:
        for line in f:
            if len(line) < 68:
                continue
            try:
                mjd = float(line[7:15])
                xp = float(line[18:27])
                yp = float(line[37:46])
                dut1 = float(line[58:68])
            except ValueError:
                continue
            mjds.append(mjd)
            duts.append(dut1)
            xps.append(xp * ARCSEC)
            yps.append(yp * ARCSEC)
    if not mjds:
        from pint_tpu_torch.exceptions import DataFileError

        raise DataFileError(f"no EOP rows parsed from {path}")
    return EOPTable(mjds, duts, xps, yps, name=os.path.basename(str(path)))


_table: EOPTable | None = None
_loaded_from_env = False


def set_eop_table(table: EOPTable | None):
    global _table
    _table = table


def reset_eop():
    """Forget the loaded table AND the env-load/warn memos (tests;
    $PINT_TPU_EOP changes)."""
    global _table, _loaded_from_env, _warned
    _table = None
    _loaded_from_env = False
    _warned = False


def get_eop(mjd_utc):
    """(dut1_s, xp_rad, yp_rad) at mjd_utc, from the loaded table or the
    zero default."""
    global _table, _loaded_from_env, _warned
    if _table is None and not _loaded_from_env:
        _loaded_from_env = True
        path = os.environ.get("PINT_TPU_EOP")
        if path and os.path.exists(path):
            _table = parse_finals2000a(path)
    if _table is not None:
        return _table.at(mjd_utc)
    if not _warned:
        _warned = True
        warnings.warn(
            "no Earth-orientation table loaded (set $PINT_TPU_EOP to an "
            "IERS finals2000A.all file); using UT1=UTC and zero polar "
            "motion (~us-level absolute timing error)"
        )
    m = np.asarray(mjd_utc, float)
    z = np.zeros_like(m)
    return z, z, z
