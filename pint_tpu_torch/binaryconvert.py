"""Binary-model parameter conversion (ELL1 <-> DD/BT families).

Counterpart of ``pint_tpu/binaryconvert.py`` (reference parity:
src/pint/binaryconvert.py::convert_binary): rewrite a TimingModel's
binary component in another parameterization, through par text
(``as_parfile``, then ``get_model``).  The load-bearing conversions:

  ELL1 -> DD/BT:  ECC = sqrt(EPS1^2+EPS2^2), OM = atan2(EPS1, EPS2),
                  T0 = TASC + OM/2pi * PB
  DD/BT -> ELL1:  EPS1 = ECC sin OM, EPS2 = ECC cos OM,
                  TASC = T0 - OM/2pi * PB
  DDS <-> DD:     SINI = 1 - exp(-SHAPMAX)
  ELL1H -> ELL1:  M2 = H3/STIGMA^3/Tsun, SINI = 2 STIGMA/(1+STIGMA^2)
"""

from __future__ import annotations

import math

import numpy as np

from pint_tpu_torch.constants import SECS_PER_DAY, SECS_PER_JULIAN_YEAR, TSUN
from pint_tpu_torch.exceptions import TimingModelError
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray

_TWO_PI = 2.0 * math.pi


def _get(model, name, default=None):
    p = model.params.get(name)
    if p is None or p.value is None:
        return default
    v = p.value
    if isinstance(v, tuple):  # an epoch: (day, HostDD seconds of day)
        day, sec = v
        t = TimeArray(np.array([day]), HostDD([sec.hi], [sec.lo]), "tdb")
        return float(t.mjd_float()[0])
    if hasattr(v, "to_float"):
        return float(v.to_float())
    return float(v)


def _binary_component(model):
    from pint_tpu_torch.models.pulsar_binary import PulsarBinary

    for c in model.components.values():
        if isinstance(c, PulsarBinary):
            return c
    raise TimingModelError("model has no binary component")


def convert_binary(model: TimingModel, target: str) -> TimingModel:
    """Return a NEW TimingModel with the binary rewritten as `target`
    ('ELL1', 'DD', 'BT', 'DDS', ...).  Non-binary components are reused
    (shared host Parameter objects are copied via parfile round-trip)."""
    from pint_tpu_torch.models.builder import get_model

    cur = _binary_component(model)
    cur_name = cur.binary_model_name.upper()
    target = target.upper()
    if target == cur_name:
        return get_model(model.as_parfile())

    par_lines = []
    skip = set()
    _DEG_YR_TO_RAD_S = math.pi / 180.0 / SECS_PER_JULIAN_YEAR
    if cur_name.startswith("ELL1") and target in ("DD", "BT", "DDS", "DDH"):
        eps1 = _get(model, "EPS1", 0.0)
        eps2 = _get(model, "EPS2", 0.0)
        ecc = math.hypot(eps1, eps2)
        om = math.atan2(eps1, eps2) % _TWO_PI
        pb_d = _get(model, "PB")
        if pb_d is None:
            fb0 = _get(model, "FB0")
            pb_d = 1.0 / fb0 / SECS_PER_DAY
        tasc = _get(model, "TASC")
        t0 = tasc + om / _TWO_PI * pb_d
        par_lines += [
            f"ECC {ecc:.15e}", f"OM {math.degrees(om):.15f}",
            f"T0 {t0:.15f}",
        ]
        # EPS1 = e sin w, EPS2 = e cos w  =>  invert the rates:
        # edot = E1D sin w + E2D cos w; wdot = (E1D cos w - E2D sin w)/e
        e1d = _get(model, "EPS1DOT", 0.0)
        e2d = _get(model, "EPS2DOT", 0.0)
        if e1d or e2d:
            if ecc == 0.0:
                raise TimingModelError(
                    "cannot convert EPS1DOT/EPS2DOT with zero eccentricity"
                )
            edot = e1d * math.sin(om) + e2d * math.cos(om)
            omdot_rad_s = (e1d * math.cos(om) - e2d * math.sin(om)) / ecc
            par_lines += [
                f"EDOT {edot:.15e}",
                f"OMDOT {omdot_rad_s / _DEG_YR_TO_RAD_S:.15e}",
            ]
        skip |= {"EPS1", "EPS2", "TASC", "EPS1DOT", "EPS2DOT"}
    elif cur_name in ("DD", "BT", "DDS", "DDGR", "DDK", "BT_PIECEWISE") \
            and target.startswith("ELL1"):
        ecc = _get(model, "ECC", 0.0)
        if ecc > 0.05:
            raise TimingModelError(
                f"ECC={ecc}: the ELL1 expansion needs e << 1"
            )
        if _get(model, "GAMMA", 0.0):
            raise TimingModelError(
                "ELL1 cannot represent GAMMA (Einstein delay); remove it "
                "or keep a DD-family model"
            )
        om = math.radians(_get(model, "OM", 0.0))
        pb_d = _get(model, "PB")
        t0 = _get(model, "T0")
        par_lines += [
            f"EPS1 {ecc * math.sin(om):.15e}",
            f"EPS2 {ecc * math.cos(om):.15e}",
            f"TASC {t0 - om / _TWO_PI * pb_d:.15f}",
        ]
        edot = _get(model, "EDOT", 0.0)
        omdot_rad_s = _get(model, "OMDOT", 0.0) * _DEG_YR_TO_RAD_S
        if edot or omdot_rad_s:
            e1d = edot * math.sin(om) + ecc * omdot_rad_s * math.cos(om)
            e2d = edot * math.cos(om) - ecc * omdot_rad_s * math.sin(om)
            par_lines += [f"EPS1DOT {e1d:.15e}", f"EPS2DOT {e2d:.15e}"]
        skip |= {"ECC", "OM", "T0", "EDOT", "OMDOT", "GAMMA"}
    elif cur_name == "DDS" and target == "DD":
        par_lines.append(
            f"SINI {1.0 - math.exp(-_get(model, 'SHAPMAX')):.15f}"
        )
        skip |= {"SHAPMAX"}
    elif cur_name == "DD" and target == "DDS":
        sini = _get(model, "SINI")
        if sini is None or not 0 < sini < 1:
            raise TimingModelError("DD->DDS needs 0 < SINI < 1")
        par_lines.append(f"SHAPMAX {-math.log(1.0 - sini):.15f}")
        skip |= {"SINI"}
    else:
        raise TimingModelError(
            f"conversion {cur_name} -> {target} not supported"
        )

    # orthometric -> physical Shapiro when leaving the H3 families
    if cur_name in ("ELL1H", "DDH") and target in ("DD", "BT", "DDS", "ELL1"):
        h3 = _get(model, "H3")
        stig = _get(model, "STIGMA")
        if h3 is not None and stig:
            par_lines += [
                f"M2 {h3 / stig**3 / TSUN:.15e}",
                f"SINI {2.0 * stig / (1.0 + stig * stig):.15f}",
            ]
        skip |= {"H3", "H4", "STIGMA", "NHARM"}

    out_lines = [f"BINARY {target}"]
    for line in model.as_parfile().splitlines():
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "BINARY" or toks[0] in skip:
            continue
        out_lines.append(line)
    out_lines += par_lines
    return get_model("\n".join(out_lines) + "\n")
