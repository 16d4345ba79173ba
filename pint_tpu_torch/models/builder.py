"""Model builder: par text -> TimingModel of the ported components.

Counterpart of ``pint_tpu/models/builder.py::get_model``, with its
selection rule: a component is included when the par text names a
parameter (or mask family, or indexed-family member such as DMX_0017)
that it alone of the ported non-binary components accepts; the binary
model is chosen by the BINARY line alone; SolarSystemShapiro comes with
astrometry.  Ported: equatorial and ecliptic astrometry, solar-system
Shapiro, DM, DMX, FD, FDJUMP, JUMP, spindown, the ten binary models,
EFAC/EQUAD, ECORR and power-law red noise.  Any other par line raises
NotImplementedError naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import io
from collections import OrderedDict

from pint_tpu_torch.models.astrometry import (
    Astrometry,
    AstrometryEcliptic,
    AstrometryEquatorial,
)
from pint_tpu_torch.models.dispersion import DispersionDM, DispersionDMX
from pint_tpu_torch.models.frequency_dependent import FD, FDJump
from pint_tpu_torch.models.jump import PhaseJump
from pint_tpu_torch.models.noise import EcorrNoise, PLRedNoise, ScaleToaError
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.pulsar_binary import BINARY_MODELS
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel

#: the non-binary components the builder chooses among
SELECTABLE = {
    cls.__name__: cls
    for cls in (AstrometryEcliptic, AstrometryEquatorial, DispersionDM,
                DispersionDMX, EcorrNoise, FD, FDJump, PLRedNoise,
                PhaseJump, ScaleToaError, SolarSystemShapiro, Spindown)
}
#: every component a state may name (``convert.state_from_numpy``)
COMPONENTS = {**SELECTABLE,
              **{cls.__name__: cls for cls in BINARY_MODELS.values()}}

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
    if name == "UNITS":
        item = "A6 (TCB parameter conversion)"
    else:
        item = ("A6 (the remaining timing-model components: solar wind, "
                "glitch, wave, ifunc, piecewise spindown, absolute phase, "
                "troposphere, chromatic, DMJUMP, phase offset, and the DM "
                "and chromatic noise)")
    return NotImplementedError(
        f"par line {name!r} is outside the ported slice; ROADMAP {item}"
    )


def _choose(pardict) -> list:
    """The reference's rule: each par name accepted by exactly one
    selectable component selects it (sorted by class name), then the
    BINARY line's model, then SolarSystemShapiro with astrometry."""
    protos = {n: cls() for n, cls in SELECTABLE.items()}
    chosen = set()
    for name in pardict:
        if name in _IGNORE:
            continue
        hits = [n for n, c in protos.items()
                if name in c.mask_families()
                or c.ensure_param(name) is not None]
        if len(hits) == 1:
            chosen.add(hits[0])
    comps = [SELECTABLE[n]() for n in sorted(chosen)]
    if sum(isinstance(c, Astrometry) for c in comps) > 1:
        raise ValueError("par text mixes equatorial (RAJ/DECJ) and "
                         "ecliptic (ELONG/ELAT) astrometry")
    if "BINARY" in pardict:
        kind = pardict["BINARY"][0][0].upper()
        if kind not in BINARY_MODELS:
            raise ValueError(f"unknown binary model {kind!r}")
        comps.append(BINARY_MODELS[kind]())
    if (any(isinstance(c, Astrometry) for c in comps)
            and not any(isinstance(c, SolarSystemShapiro) for c in comps)):
        comps.append(SolarSystemShapiro())
    return comps


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
    comps = _choose(pardict)
    model = TimingModel(components=comps)
    counters: dict[tuple[int, str], int] = {}
    for name, entries in pardict.items():
        if name in _IGNORE or name in ("UNITS", "BINARY"):
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
