"""Model builder: par text -> TimingModel of the ported components.

Counterpart of ``pint_tpu/models/builder.py::get_model``, with its
selection rule: a component is included when the par text names a
parameter (or mask family, or indexed-family member such as DMX_0017)
that it alone of the ported non-binary components accepts; the binary
model is chosen by the BINARY line alone; SolarSystemShapiro comes with
astrometry.  Every component of the reference is ported, the wideband
DMJUMP (``DMJump``) and DMEFAC/DMEQUAD (``ScaleDmError``) included.  A
line no component
accepts is left out with an ``UnknownParameterWarning`` and kept in
``model.unrecognized``, as the reference's builder does.  ``UNITS TCB``
converts the parameters to TDB (``tcb_conversion.py``).
"""

from __future__ import annotations

import warnings

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.io.par import parse_parfile
from pint_tpu_torch.models.absolute_phase import AbsPhase
from pint_tpu_torch.models.astrometry import (
    Astrometry,
    AstrometryEcliptic,
    AstrometryEquatorial,
)
from pint_tpu_torch.models.chromatic import ChromaticCM
from pint_tpu_torch.models.dispersion import (
    DispersionDM,
    DispersionDMX,
    DMJump,
)
from pint_tpu_torch.models.frequency_dependent import FD, FDJump
from pint_tpu_torch.models.glitch import Glitch
from pint_tpu_torch.models.ifunc import IFunc
from pint_tpu_torch.models.jump import PhaseJump
from pint_tpu_torch.models.noise import (
    EcorrNoise,
    PLChromNoise,
    PLDMNoise,
    PLRedNoise,
    ScaleDmError,
    ScaleToaError,
)
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.phase_offset import PhaseOffset
from pint_tpu_torch.models.piecewise import PiecewiseSpindown
from pint_tpu_torch.models.pulsar_binary import BINARY_MODELS
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.solar_wind import (
    SolarWindDispersion,
    SolarWindDispersionX,
)
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.models.troposphere import TroposphereDelay
from pint_tpu_torch.models.wave import CMWaveX, DMWaveX, Wave, WaveX

#: the non-binary components the builder chooses among
SELECTABLE = {
    cls.__name__: cls
    for cls in (AbsPhase, AstrometryEcliptic, AstrometryEquatorial,
                CMWaveX, ChromaticCM, DMJump, DMWaveX, DispersionDM,
                DispersionDMX, EcorrNoise, FD, FDJump, Glitch, IFunc,
                PLChromNoise, PLDMNoise, PLRedNoise, PhaseJump, PhaseOffset,
                PiecewiseSpindown, ScaleDmError, ScaleToaError,
                SolarSystemShapiro,
                SolarWindDispersion, SolarWindDispersionX, Spindown,
                TroposphereDelay, Wave, WaveX)
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


class UnknownParameterWarning(UserWarning):
    """Par lines that no component accepts (the model still builds)."""


class TZRDeferredWarning(UserWarning):
    """The TZR reference arrival could not be ingested when the model
    was built; it is ingested at compile, under the environment in scope
    then."""


def _ingest_tzr_eagerly(model: TimingModel) -> None:
    """Ingest the TZR arrival now: the clock/EOP/ephemeris environment in
    scope at build time is the one the reference arrival must use.  An
    environment failure (unknown TZRSITE, missing or malformed data
    files) must not break parse-only work: it warns, and compile raises
    if it still cannot ingest then.  Anything else propagates."""
    absph = model.components.get("AbsPhase")
    if absph is None or not absph.anchored:
        return
    try:
        absph.ingested_tzr_toas(model)
    except (PintTpuError, OSError) as e:
        warnings.warn(
            f"TZR reference arrival could not be ingested at model build "
            f"({e}); phase anchoring is deferred to compile() under the "
            "environment in scope then", TZRDeferredWarning)


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


def get_model(par) -> TimingModel:
    """Par file (path, text or open file) -> validated TimingModel of the
    ported components."""
    pardict = parse_parfile(par)
    units = pardict.get("UNITS", [["TDB"]])[0][0].upper()
    if units not in ("TDB", "TCB"):
        raise ValueError(f"UNITS {units!r}: only TDB and TCB par files")
    comps = _choose(pardict)
    model = TimingModel(components=comps)
    counters: dict[tuple[int, str], int] = {}
    unknown = {}
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
            unknown[name] = entries
    if unknown:
        warnings.warn(f"unrecognized par-file parameters {sorted(unknown)}",
                      UnknownParameterWarning)
    model.unrecognized = unknown
    psr = next((model.top_params[k] for k in ("PSR", "PSRJ", "PSRB")
                if k in model.top_params), None)
    model.name = psr.value if psr is not None else ""
    if units == "TCB":
        convert_tcb_tdb(model)
    model.setup()
    model.validate()
    _ingest_tzr_eagerly(model)
    return model


def get_model_and_toas(par, tim, ephem: str = None, planets: bool = None,
                       usepickle: bool = False, **ingest_kw):
    """Load a par/tim pair and ingest the TOAs through the model's chain
    (its EPHEM, PLANET_SHAPIRO and CLOCK lines; ``ephem`` and
    ``planets`` override them).  ``usepickle=True`` goes through the
    ingest cache (``toas/cache.py::get_TOAs``).  -> (model, TOAs)."""
    from pint_tpu_torch.toas.cache import get_TOAs

    model = get_model(par)
    if ephem is not None:
        ingest_kw["ephem"] = ephem
    if planets is not None:
        ingest_kw["planets"] = planets
    toas = get_TOAs(tim, model=model, usepickle=usepickle, **ingest_kw)
    return model, toas
