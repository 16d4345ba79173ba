"""Timing-model parameters.

Counterpart of ``pint_tpu/models/parameter.py``: float (f64 or
double-double), MJD epoch, angle, mask, pair, bool, int and string
parameters, the ``prefixParameter`` factory of indexed families and the
read-only derived ``funcParameter``.
Each declares its par-file ``units`` and a ``scale_to_internal`` factor to
the unit-free internal convention (seconds, radians, Hz) the kernels read.

Internal values, as :func:`reference_values` hands them to kernels:

- f64 float, angle, mask: a Python float;
- double-double float (F0): a :class:`HostDD` scalar;
- epoch: ``(mjd_int, HostDD seconds-of-day)``;
- pair: a ``(float, float)`` tuple.
"""

from __future__ import annotations

import re
from decimal import Decimal, localcontext
from typing import Callable, Optional

import numpy as np

from pint_tpu_torch.constants import DEG_TO_RAD, HOUR_TO_RAD, SECS_PER_DAY
from pint_tpu_torch.exceptions import PintTpuError, PrefixError
from pint_tpu_torch.timebase.hostdd import HostDD, carry_days

_FORTRAN_EXP = re.compile(r"[dD]")


def _fortran_to_e(s: str) -> str:
    return _FORTRAN_EXP.sub("e", s)


def _parse_float_str(s: str) -> float:
    return float(_fortran_to_e(s))


def _format_sexagesimal(val: float, ndp: int) -> str:
    sign = "-" if val < 0 else ""
    val = abs(val)
    d = int(val)
    rem = (val - d) * 60.0
    m = int(rem)
    s = (rem - m) * 60.0
    # guard against 59.99999 -> 60 rollover
    s_str = f"{s:0{3 + ndp}.{ndp}f}"
    if float(s_str) >= 60.0:
        s_str = f"{0.0:0{3 + ndp}.{ndp}f}"
        m += 1
    if m >= 60:
        m -= 60
        d += 1
    return f"{sign}{d:02d}:{m:02d}:{s_str}"


def _parse_sexagesimal(s: str) -> tuple[float, int]:
    s = s.strip()
    sign = 1
    if s.startswith("-"):
        sign, s = -1, s[1:]
    elif s.startswith("+"):
        s = s[1:]
    parts = s.split(":")
    if len(parts) > 3 or any(p == "" for p in parts):
        raise ValueError(f"bad sexagesimal angle {s!r}")
    val = 0.0
    for i, p in enumerate(parts):
        val += float(p) / 60.0**i
    return val, sign


class Parameter:
    """Base parameter.  The internal (kernel-unit) value is what the
    parameter stores: ``value`` reads and writes it in par-file units
    through ``scale_to_internal``, so a value set from exported internal
    state reaches the kernels bit for bit."""

    #: a parameter of a continuous value (``TimingModel.fittable_params``)
    continuous = True

    def __init__(self, name, value=None, units="", aliases=(), frozen=True,
                 uncertainty: Optional[float] = None, scale_to_internal=1.0):
        self.name = name
        self.units = units
        self.aliases = tuple(aliases)
        self.frozen = frozen
        self.uncertainty = uncertainty
        self.scale_to_internal = scale_to_internal
        self._internal = None
        self.value = value

    @property
    def value(self):
        return None if self._internal is None else self._from_internal(
            self._internal
        )

    @value.setter
    def value(self, v):
        self._internal = None if v is None else self._to_internal(v)
        # the value as given, while the internal value is the one it set
        # (``_format_value`` writes it, as the reference stores it)
        self._given = (self._internal, v)

    def _par_value(self):
        """The value in par-file units: the one last given while the
        internal value is still the one it set, else internal / scale
        (the reference's value after ``set_internal``)."""
        given = getattr(self, "_given", None)
        if given is not None and given[0] is self._internal:
            return given[1]
        return self.value

    @property
    def quantity(self):
        """The value in par-file units (the reference's name for it)."""
        return self.value

    def _to_internal(self, v):
        return v * self.scale_to_internal

    def _from_internal(self, i):
        return i / self.scale_to_internal

    def name_matches(self, name: str) -> bool:
        name = name.upper()
        return name == self.name.upper() or name in (
            a.upper() for a in self.aliases
        )

    def set_from_tokens(self, tokens: list[str]):
        """tokens: [value] or [value fit] or [value fit unc].  A parameter
        read from a par file is frozen unless its fit flag is '1' (tempo
        convention); any other numeric second token is an uncertainty."""
        self.value = self._parse_value_str(tokens[0])
        self.frozen = True
        if len(tokens) >= 2:
            if tokens[1] in ("0", "1"):
                self.frozen = tokens[1] == "0"
                if len(tokens) >= 3:
                    self.uncertainty = _parse_float_str(tokens[2])
            else:
                self.uncertainty = _parse_float_str(tokens[1])

    def _parse_value_str(self, s: str):
        return s

    def internal(self):
        return self._internal

    def set_internal(self, v):
        self._internal = v

    def internal_uncertainty(self):
        """The uncertainty in internal units (None when unset)."""
        if self.uncertainty is None:
            return None
        return self.uncertainty * self.scale_to_internal

    def set_internal_uncertainty(self, u):
        self.uncertainty = u / self.scale_to_internal

    def _format_value(self) -> str:
        """The value as the reference's ``_format_value`` writes it (the
        fitters' ``print_summary`` table)."""
        return str(self._par_value())

    def as_parfile_line(self) -> str:
        """The parameter's par-file line ('' when unset), as the
        reference's ``as_parfile_line`` writes it: name, value, the fit
        flag when free, and the uncertainty."""
        if self.value is None:
            return ""
        line = f"{self.name:<15} {self._format_value():>25}"
        return line + self._fit_and_uncertainty()

    def _fit_and_uncertainty(self) -> str:
        tail = "" if self.frozen else " 1"
        if self.uncertainty is not None:
            if self.frozen:
                tail += " 0"
            tail += f" {self.uncertainty:.8g}"
        return tail + "\n"

    def __repr__(self):
        fit = "" if self.frozen else " FIT"
        return f"<{type(self).__name__} {self.name}={self.value}{fit}>"


#: the tempo convention of PBDOT, XDOT, EDOT and the like: par values
#: larger than the threshold are in units of the factor
TEMPO_SCALE_THRESHOLD = 1e-7
TEMPO_SCALE_FACTOR = 1e-12


class floatParameter(Parameter):
    """f64 or double-double (``long_double``) float; ``unit_scale``
    parameters read par values by the tempo convention above."""

    def __init__(self, name, value=None, long_double=False,
                 unit_scale=False, **kw):
        # long_double (reference naming) => double-double precision
        self.precision = "dd" if long_double else "f64"
        self.unit_scale = unit_scale
        self._applied_scale = False
        super().__init__(name, value=value, **kw)

    def _parse_value_str(self, s):
        if self.precision == "dd":
            v = HostDD.from_string(_fortran_to_e(s))
            big = abs(float(v.to_float())) > TEMPO_SCALE_THRESHOLD
        else:
            v = _parse_float_str(s)
            big = abs(v) > TEMPO_SCALE_THRESHOLD
        if self.unit_scale and big:
            self._applied_scale = True
            return v * TEMPO_SCALE_FACTOR
        return v

    def set_from_tokens(self, tokens):
        self._applied_scale = False
        super().set_from_tokens(tokens)
        # the tempo scaling applies to an uncertainty of these tokens
        has_unc = len(tokens) >= 3 or (
            len(tokens) == 2 and tokens[1] not in ("0", "1")
        )
        if self._applied_scale and has_unc and self.uncertainty is not None:
            self.uncertainty *= TEMPO_SCALE_FACTOR

    def set_internal(self, v):
        if self.precision == "dd" and not isinstance(v, HostDD):
            v = HostDD(np.float64(v))
        self._internal = v

    def _format_value(self):
        v = self._par_value()
        if isinstance(v, HostDD):
            with localcontext() as ctx:
                ctx.prec = 40
                d = Decimal(float(v.hi)) + Decimal(float(v.lo))
                return f"{d:.25g}"
        return f"{v:.17g}"


class intParameter(Parameter):
    """An integer; its internal value is the integer times
    ``scale_to_internal``, as the reference's."""

    def _parse_value_str(self, s):
        return int(float(s))

    def _to_internal(self, v):
        return int(v)

    def _from_internal(self, i):
        return i

    def internal(self):
        return None if self._internal is None else (
            self._internal * self.scale_to_internal)

    def set_internal(self, v):
        self.value = v / self.scale_to_internal


def s_to_bool(s: str) -> bool:
    """Par-file truth value: Y/YES/T/TRUE/1 or N/NO/F/FALSE/0, any case."""
    s = s.strip().upper()
    if s in ("Y", "YES", "T", "TRUE", "1"):
        return True
    if s in ("N", "NO", "F", "FALSE", "0"):
        return False
    raise PintTpuError(f"cannot parse bool {s!r}")


class boolParameter(Parameter):
    def _parse_value_str(self, s):
        return s_to_bool(s)

    def set_from_tokens(self, tokens):
        self.value = tokens[0] if tokens else True

    def _to_internal(self, v):
        return s_to_bool(v) if isinstance(v, str) else bool(v)

    def _from_internal(self, i):
        return i

    def _par_value(self):
        return self._internal  # the reference keeps the parsed truth value

    def _format_value(self):
        return "Y" if self.value else "N"


class strParameter(Parameter):
    def set_from_tokens(self, tokens):
        self.value = " ".join(tokens)

    def _to_internal(self, v):
        return v

    _from_internal = _to_internal


class MJDParameter(Parameter):
    """Epoch parameter (PEPOCH, POSEPOCH, DMEPOCH), exact two-part;
    ``time_scale`` names its scale (TDB but for TZRMJD's UTC)."""

    def __init__(self, name, value=None, time_scale="tdb", **kw):
        self.time_scale = time_scale
        kw.setdefault("units", "MJD")
        super().__init__(name, value=value, **kw)

    def _parse_value_str(self, s):
        """pulsar_mjd convention: fraction of an 86400 s day."""
        s = _fortran_to_e(s).strip()
        if s.startswith("-") or "e" in s.lower():
            raise ValueError(f"unsupported MJD string {s!r}")
        ipart, _, fpart = s.partition(".")
        sec = HostDD.from_string("0." + (fpart or "0")) * SECS_PER_DAY
        return int(ipart), HostDD(sec.hi, sec.lo)

    def _to_internal(self, v):
        """-> (mjd_int, sec HostDD scalar)."""
        return v

    _from_internal = _to_internal

    def add_internal_delta(self, dsec: float):
        """Shift the epoch by dsec seconds, carrying whole days."""
        day, sec = self.value
        d, s = carry_days(np.asarray([day]), HostDD([sec.hi], [sec.lo]) + dsec)
        self.value = (int(d[0]), HostDD(s.hi[0], s.lo[0]))

    def set_internal(self, v):
        raise PintTpuError(
            "epoch parameters update via add_internal_delta, not set_internal"
        )

    def internal_uncertainty(self):
        """Uncertainty in seconds (par files carry days)."""
        if self.uncertainty is None:
            return None
        return self.uncertainty * 86400.0

    def set_internal_uncertainty(self, u):
        self.uncertainty = u / SECS_PER_DAY  # par files carry days

    def _format_value(self):
        """pulsar_mjd text with 15 decimals."""
        day, sec = self.value
        with localcontext() as ctx:
            ctx.prec = 40
            frac = (Decimal(float(sec.hi)) + Decimal(float(sec.lo))) / (
                Decimal(86400))
            total = Decimal(int(day)) + frac
            return f"{total:.15f}"


class AngleParameter(Parameter):
    """RAJ/DECJ; internal radians.  Uncertainties in the par file are
    seconds of time (H:M:S) or arcseconds (D:M:S), tempo convention."""

    #: par-file uncertainty units per radian (tempo convention)
    _UNC_PER_RAD = {
        "H:M:S": 12.0 * 3600.0,
        "D:M:S": 180.0 * 3600.0,
        "deg": 180.0,
    }

    def __init__(self, name, value=None, units="rad", **kw):
        super().__init__(name, value=value, units=units, **kw)

    def _parse_value_str(self, s):
        if self.units == "H:M:S":
            val, sign = _parse_sexagesimal(s)
            return sign * val * HOUR_TO_RAD
        if self.units == "D:M:S":
            val, sign = _parse_sexagesimal(s)
            return sign * val * DEG_TO_RAD
        if self.units == "deg":
            return _parse_float_str(s) * np.pi / 180.0
        return _parse_float_str(s)

    def _to_internal(self, v):
        return float(v)  # radians

    _from_internal = _to_internal

    def set_internal(self, v):
        self._internal = float(v)

    def internal_uncertainty(self):
        """Uncertainty in radians: par-file uncertainties for H:M:S are in
        seconds of time, for D:M:S in arcseconds (tempo convention)."""
        if self.uncertainty is None:
            return None
        per = self._UNC_PER_RAD.get(self.units)
        return self.uncertainty if per is None else (
            self.uncertainty * np.pi / per)

    def set_internal_uncertainty(self, u):
        per = self._UNC_PER_RAD.get(self.units)
        self.uncertainty = u if per is None else u * per / np.pi

    def _format_value(self):
        v = self.value
        if self.units == "H:M:S":
            return _format_sexagesimal(v / HOUR_TO_RAD, 11)
        if self.units == "D:M:S":
            out = _format_sexagesimal(v / DEG_TO_RAD, 10)
            return out if out.startswith("-") else "+" + out
        if self.units == "deg":
            return f"{v * 180.0 / np.pi:.17g}"
        return f"{v:.17g}"


class maskParameter(floatParameter):
    """Parameter applying to a TOA subset (EFAC, EQUAD, ...).  Selections
    are computed on the host at compile time and become static 0/1
    columns in the bundle."""

    def __init__(self, name, key=None, key_value=(), **kw):
        self.key = key  # '-flag', 'mjd', 'freq'
        self.key_value = list(key_value)
        super().__init__(name, **kw)

    def set_from_tokens(self, tokens):
        key = tokens[0]
        if key.lower() in ("mjd", "freq"):
            self.key = key.lower()
            self.key_value = [float(tokens[1]), float(tokens[2])]
            rest = tokens[3:]
        elif key.lower() in ("tel", "name"):
            self.key = key.lower()
            self.key_value = [tokens[1]]
            rest = tokens[2:]
        elif key.startswith("-"):
            self.key = key
            self.key_value = [tokens[1]]
            rest = tokens[2:]
        else:
            raise PintTpuError(
                f"cannot parse mask parameter {self.name} key {key!r}"
            )
        if rest:
            super().set_from_tokens(rest)
        else:
            self.value = 0.0

    def select(self, toas) -> np.ndarray:
        """Boolean mask over a TOA table or TOAs (host-side).  ``tel``
        compares the table's site codes case-insensitively with the key's,
        as the reference does (an alias such as '1' for gbt is another
        code); ``name`` reads the ``name`` flag."""
        from pint_tpu_torch.toas.bundle import as_table, table_mjd

        toas = as_table(toas)
        n = len(toas["freq_mhz"])
        if self.key is None:
            return np.ones(n, dtype=bool)
        if self.key == "mjd":
            m = table_mjd(toas)
            return (m >= self.key_value[0]) & (m <= self.key_value[1])
        if self.key == "freq":
            f = toas["freq_mhz"]
            return (f >= self.key_value[0]) & (f <= self.key_value[1])
        if self.key == "tel":
            want = self.key_value[0].lower()
            obs = toas.get("obs")
            if obs is None:
                raise ValueError(
                    f"{self.name}: a 'tel' selection needs the table's "
                    "site codes (an ingested TOAs' table has them)")
            return np.array([o.lower() == want for o in obs], dtype=bool)
        flag = self.key.lstrip("-")
        want = str(self.key_value[0])
        return np.array([str(f.get(flag, "")) == want for f in toas["flags"]],
                        dtype=bool)

    def as_parfile_line(self) -> str:
        """``PREFIX key key_value(s) value [fit] [unc]``, the selection
        written as it was read."""
        if self.value is None:
            return ""
        if self.key is None:
            key_str = ""
        elif self.key in ("mjd", "freq"):
            key_str = (f"{self.key} {self.key_value[0]:.8f} "
                       f"{self.key_value[1]:.8f} ")
        else:
            key_str = f"{self.key} {self.key_value[0]} "
        line = f"{self.name_no_index:<8} {key_str}{self._format_value()}"
        return line + self._fit_and_uncertainty()

    @property
    def name_no_index(self) -> str:
        """The family's prefix: 'JUMP' of JUMP3."""
        return re.sub(r"\d+$", "", self.name)


class pairParameter(Parameter):
    """Two-part parameter (WAVE1: sin and cos amplitudes; IFUNC1: MJD and
    seconds).  Its internal value is a (float, float) tuple, static in
    the kernels, and it is never fitted."""

    def set_from_tokens(self, tokens):
        self.value = (_parse_float_str(tokens[0]),
                      _parse_float_str(tokens[1]))

    def _to_internal(self, v):
        a, b = v
        return (float(a) * self.scale_to_internal,
                float(b) * self.scale_to_internal)

    def _from_internal(self, i):
        return (i[0] / self.scale_to_internal, i[1] / self.scale_to_internal)

    def _format_value(self):
        a, b = self._par_value()
        return f"{a:.17g} {b:.17g}"


class funcParameter(Parameter):
    """Read-only parameter derived from others: ``func`` of the values
    of ``params`` (names on the model), never written to a par file."""

    def __init__(self, name, func=None, params=(), **kw):
        self._func = func
        self._params = params
        super().__init__(name, **kw)

    def evaluate(self, model):
        vals = [getattr(model, p).value for p in self._params]
        if any(v is None for v in vals):
            return None
        return self._func(*vals)

    def as_parfile_line(self):
        return ""  # derived, never written


class prefixParameter:
    """Factory of an indexed family (F2.., DMX_0001, WXSIN_0001, ...): a
    template parameter type stamped out by index on demand."""

    def __init__(self, prefix: str, index_format: str = "d",
                 template: Callable[[str], Parameter] = None,
                 start_index: int = 0):
        self.prefix = prefix
        self.index_format = index_format
        self.template = template
        self.start_index = start_index

    def match(self, name: str) -> Optional[int]:
        """The index of ``name`` in this family, else None."""
        return prefix_index(name, self.prefix)

    def instance(self, index: int) -> Parameter:
        par = self.template(f"{self.prefix}{index:{self.index_format}}")
        par.index = index
        return par


def prefix_index(name: str, prefix: str) -> Optional[int]:
    """Index of a prefixed-family name ('FB12', 'FB') -> 12; None if
    ``name`` is not ``prefix`` followed by digits."""
    name, prefix = name.upper(), prefix.upper()
    if not name.startswith(prefix):
        return None
    tail = name[len(prefix):]
    return int(tail) if tail.isdigit() else None


def split_prefixed_name(name: str) -> tuple[str, str, int]:
    """'DMX_0017' -> ('DMX_', '0017', 17); 'F12' -> ('F', '12', 12)."""
    m = re.match(r"^([A-Za-z0-9_]*?[A-Za-z_])(\d+)$", name)
    if m is None:
        raise PrefixError(f"{name!r} is not a prefixed parameter name")
    return m.group(1), m.group(2), int(m.group(2))
