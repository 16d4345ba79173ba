"""Model builder: par text -> TimingModel, for the slice's six components.

Counterpart of ``pint_tpu/models/builder.py::get_model``, cut to the
components of the GLS fit-step slice: AstrometryEquatorial,
SolarSystemShapiro, DispersionDM, Spindown, PLRedNoise and ScaleToaError.
A component is included when the par text names one of its trigger
parameters; SolarSystemShapiro comes with astrometry.  Any other par line
raises NotImplementedError naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import io
from collections import OrderedDict

from pint_tpu_torch.models.astrometry import AstrometryEquatorial
from pint_tpu_torch.models.dispersion import DispersionDM
from pint_tpu_torch.models.noise import PLRedNoise, ScaleToaError
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel

COMPONENTS = {
    cls.__name__: cls
    for cls in (AstrometryEquatorial, DispersionDM, PLRedNoise,
                ScaleToaError, Spindown, SolarSystemShapiro)
}

# par-file lines that are not parameters
_IGNORE = {"MODE", "EPHVER", "END", "NITS", "IBOOT"}

#: top-level metadata lines, kept as strings and never read by a kernel
_TOP_STR = ("PSR", "PSRJ", "PSRB", "EPHEM", "CLOCK", "CLK", "TIMEEPH",
            "T2CMETHOD", "DILATEFREQ", "INFO", "DMDATA")
_TOP_FLOAT = ("NTOA", "TRES", "CHI2", "CHI2R")
_TOP_MJD = ("START", "FINISH")


def parse_parfile(text: str) -> "OrderedDict[str, list[list[str]]]":
    """Par text -> {UPPER_NAME: [token-list, ...]} (repeats allowed)."""
    out: OrderedDict[str, list[list[str]]] = OrderedDict()
    for raw in io.StringIO(text):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.upper().startswith(("C ", "CC ")):
            continue
        line = line.split("#", 1)[0].strip()
        tokens = line.split()
        if tokens:
            out.setdefault(tokens[0].upper(), []).append(tokens[1:])
    return out


def _not_ported(name: str) -> NotImplementedError:
    if name in ("BINARY", "UNITS"):
        item = "A6 (binary models and TCB parameter conversion)"
    else:
        item = "A6 (the remaining timing-model components)"
    return NotImplementedError(
        f"par line {name!r} is outside the ported slice; ROADMAP {item}"
    )


def _top_param(name, tokens):
    if name in _TOP_MJD:
        p = MJDParameter(name)
    elif name in _TOP_FLOAT:
        p = floatParameter(name)
    else:
        p = strParameter(name)
    p.set_from_tokens(tokens)
    return p


def get_model(par_text: str) -> TimingModel:
    """Par-file text -> validated TimingModel of the slice's components."""
    pardict = parse_parfile(par_text)
    units = pardict.get("UNITS", [["TDB"]])[0][0].upper()
    if units != "TDB":
        raise _not_ported("UNITS")
    chosen = set()
    for name in pardict:
        for cname, cls in COMPONENTS.items():
            if name in cls.triggers:
                chosen.add(cname)
    if "AstrometryEquatorial" in chosen:
        chosen.add("SolarSystemShapiro")
    # sorted by class name, SolarSystemShapiro last: the reference
    # builder's insertion order, which fixes the noise-basis column order
    comps = [COMPONENTS[n]() for n in sorted(chosen - {"SolarSystemShapiro"})]
    if "SolarSystemShapiro" in chosen:
        comps.append(SolarSystemShapiro())
    model = TimingModel(components=comps)
    counters: dict[tuple[int, str], int] = {}
    for name, entries in pardict.items():
        if name in _IGNORE or name == "UNITS":
            continue
        if name in _TOP_STR + _TOP_FLOAT + _TOP_MJD:
            model.top_params[name] = _top_param(name, entries[0])
            continue
        routed = False
        for c in model.components.values():
            fams = c.mask_families()
            if name in fams:
                key = (id(c), name)
                for tokens in entries:
                    counters[key] = counters.get(key, 0) + 1
                    fams[name](counters[key]).set_from_tokens(tokens)
                routed = True
                break
            p = c.ensure_param(name)
            if p is not None:
                p.set_from_tokens(entries[0])
                routed = True
                break
        if not routed:
            raise _not_ported(name)
    psr = next((model.top_params[k] for k in ("PSR", "PSRJ", "PSRB")
                if k in model.top_params), None)
    model.name = psr.value if psr is not None else ""
    model.setup()
    model.validate()
    return model
