"""Sexagesimal angle parsing and formatting (par-file RAJ/DECJ).

Counterpart of ``pint_tpu/utils/angles.py``: RAJ is hours:min:sec, DECJ
degrees:min:sec, the internal value radians.  The sexagesimal split and
join are the parameter layer's (``models/parameter.py``).
"""

from __future__ import annotations

from pint_tpu_torch.constants import DEG_TO_RAD, HOUR_TO_RAD
from pint_tpu_torch.models.parameter import (
    _format_sexagesimal,
    _parse_sexagesimal,
)


def parse_angle_hms(s: str) -> float:
    """'HH:MM:SS.sss' (or decimal hours) -> radians."""
    val, sign = _parse_sexagesimal(s)
    return sign * val * HOUR_TO_RAD


def parse_angle_dms(s: str) -> float:
    """'+DD:MM:SS.sss' (or decimal degrees) -> radians."""
    val, sign = _parse_sexagesimal(s)
    return sign * val * DEG_TO_RAD


def format_angle_hms(rad: float, ndp: int = 11) -> str:
    return _format_sexagesimal(rad / HOUR_TO_RAD, ndp)


def format_angle_dms(rad: float, ndp: int = 10) -> str:
    out = _format_sexagesimal(rad / DEG_TO_RAD, ndp)
    return out if out.startswith("-") else "+" + out
