"""TCB -> TDB parameter conversion of a par file with ``UNITS TCB``.

Counterpart of ``pint_tpu/models/tcb_conversion.py::convert_tcb_tdb``.
dTDB/dTCB = 1 - L_B, so a parameter of effective time dimension d (value
~ s^d) scales as value_tdb = value_tcb (1 - L_B)^d, and an epoch goes
through the full TCB -> TDB conversion (``timebase/scales.py``).  The
scale is formed and applied in double-double: a plain f64 product carries
~1e-16 relative rounding, which on F0 is a ~6 ns phase error over
golden23's 1300-day span.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import L_B
from pint_tpu_torch.models.parameter import MJDParameter, strParameter
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.scales import tcb_to_tdb

# parameter name -> effective time dimension d (value ~ s^d)
_DIMENSIONS = {
    "F0": -1, "F1": -2, "F2": -3, "F3": -4, "F4": -5, "F5": -6,
    "PB": 1, "A1": 1, "FB0": -1, "FB1": -2, "FB2": -3,
    "GAMMA": 1, "M2": 0, "MTOT": 0,
    "DM": -1, "NE_SW": -1,
    "PX": 0, "OM": 0, "ECC": 0, "SINI": 0,
    "OMDOT": -1, "PBDOT": 0, "EDOT": -1, "A1DOT": 0,
}

_PREFIX_DIMS = [
    ("F", lambda k: -(k + 1)),  # F0..Fn
    ("DMX_", lambda k: -1),
    ("GLF0_", lambda k: -1),
    ("GLF1_", lambda k: -2),
    ("GLF2_", lambda k: -3),
]


def _dimension(name: str):
    if name in _DIMENSIONS:
        return _DIMENSIONS[name]
    for pref, fn in _PREFIX_DIMS:
        rest = name[len(pref):]
        if name.startswith(pref) and rest.isdigit():
            return fn(int(rest))
    return None


def convert_tcb_tdb(model):
    """Convert a model's parameters in place TCB -> TDB: epochs through
    the time-scale hop, dimensioned parameters by (1 - L_B)^d in
    double-double."""
    one_minus = HostDD(1.0) - L_B
    for name, p in model.params.items():
        if p.value is None:
            continue
        if isinstance(p, MJDParameter):
            day, sec = p.value
            d, s = tcb_to_tdb(np.array([day]), HostDD([sec.hi], [sec.lo]))
            p.value = (int(d[0]), HostDD(s.hi[0], s.lo[0]))
            continue
        d = _dimension(name)
        if not d:
            continue
        scale = HostDD(1.0)
        for _ in range(abs(d)):
            scale = scale * one_minus if d > 0 else scale / one_minus
        iv = p.internal()
        if isinstance(iv, HostDD):
            p.set_internal(iv * scale)
        else:
            p.set_internal(float(HostDD(float(iv)) * scale))
    units = strParameter("UNITS")
    units.value = "TDB"
    model.top_params["UNITS"] = units
    return model
