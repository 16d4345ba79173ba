"""Model builder: par text -> TimingModel of the ported components.

Counterpart of ``pint_tpu/models/builder.py``: ``ModelBuilder`` (its
``choose_components`` and ``__call__``) and ``get_model``, with the
reference's selection rule: a component is included when the par text names a
parameter (or mask family, or indexed-family member such as DMX_0017)
that it alone of the registered non-binary components
(``Component.component_types``) accepts; the binary model is chosen by
the BINARY line alone; SolarSystemShapiro comes with astrometry.  Every
component of the reference is ported, the wideband DMJUMP (``DMJump``)
and DMEFAC/DMEQUAD (``ScaleDmError``) included.  A line no component
accepts is left out with an ``UnknownParameterWarning`` and kept in
``model.unrecognized``, as the reference's builder does.  ``UNITS TCB``
converts the parameters to TDB (``tcb_conversion.py``); any other UNITS
but TDB raises ``TimingModelError`` (the reference reads such a par file
as TDB without a word).  An unknown BINARY model or mixed equatorial and
ecliptic astrometry raises ``TimingModelError``, as in the reference.
Par text read before, in the same data environment, comes from the parse
cache as a clone.
"""

from __future__ import annotations

import hashlib
import os
import threading
import warnings
from collections import OrderedDict

# the component modules, imported so that the registry is filled
import pint_tpu_torch.models.absolute_phase  # noqa: F401
import pint_tpu_torch.models.chromatic  # noqa: F401
import pint_tpu_torch.models.dispersion  # noqa: F401
import pint_tpu_torch.models.frequency_dependent  # noqa: F401
import pint_tpu_torch.models.glitch  # noqa: F401
import pint_tpu_torch.models.ifunc  # noqa: F401
import pint_tpu_torch.models.jump  # noqa: F401
import pint_tpu_torch.models.noise  # noqa: F401
import pint_tpu_torch.models.phase_offset  # noqa: F401
import pint_tpu_torch.models.piecewise  # noqa: F401
import pint_tpu_torch.models.solar_wind  # noqa: F401
import pint_tpu_torch.models.spindown  # noqa: F401
import pint_tpu_torch.models.troposphere  # noqa: F401
import pint_tpu_torch.models.wave  # noqa: F401
from pint_tpu_torch.exceptions import PintTpuError, TimingModelError
from pint_tpu_torch.io.par import parse_parfile
from pint_tpu_torch.models.astrometry import Astrometry
from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.pulsar_binary import BINARY_MODELS, PulsarBinary
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.runtime import lockwitness

#: every registered component (``Component.component_types``), which a
#: state may name (``convert.state_from_numpy``)
COMPONENTS = dict(Component.component_types)
#: the non-binary components the builder chooses among
SELECTABLE = {n: cls for n, cls in COMPONENTS.items()
              if not issubclass(cls, PulsarBinary)}

# par-file lines that are not parameters
_IGNORE = {"MODE", "EPHVER", "END", "NITS", "IBOOT"}

#: top-level metadata lines, kept as strings and never read by a kernel
_TOP_STR = ("PSR", "PSRJ", "PSRB", "EPHEM", "CLOCK", "CLK", "TIMEEPH",
            "T2CMETHOD", "DILATEFREQ", "INFO", "DMDATA", "BINARY")
_TOP_FLOAT = ("NTOA", "TRES", "CHI2", "CHI2R")
_TOP_MJD = ("START", "FINISH")
#: the reference's aliases of top-level lines: each is kept under its
#: parameter's own name (a PSRJ line sets PSR, a CLK line CLOCK)
_TOP_ALIASES = {"PSRJ": "PSR", "PSRB": "PSR", "CLK": "CLOCK"}


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


class ModelBuilder:
    """Par file -> validated TimingModel (reference:
    ``pint_tpu/models/builder.py::ModelBuilder``): ``choose_components``
    picks the components from the parsed par dict, ``__call__`` builds
    the model, routes every line to its parameter, validates it and
    ingests its TZR arrival."""

    def __init__(self):
        self.registry = dict(Component.component_types)

    def choose_components(self, pardict) -> list:
        """The reference's rule: each par name accepted by exactly one
        non-binary component selects it (sorted by class name), then the
        BINARY line's model, then SolarSystemShapiro with astrometry."""
        protos = {n: cls() for n, cls in self.registry.items()
                  if not issubclass(cls, PulsarBinary)}
        chosen = set()
        for name in pardict:
            if name in _IGNORE:
                continue
            hits = [n for n, c in protos.items()
                    if name in c.mask_families()
                    or c.ensure_param(name) is not None]
            if len(hits) == 1:
                chosen.add(hits[0])
        comps = [self.registry[n]() for n in sorted(chosen)]
        if sum(isinstance(c, Astrometry) for c in comps) > 1:
            raise TimingModelError(
                "par file mixes equatorial (RAJ/DECJ) and ecliptic "
                "(ELONG/ELAT) astrometry")
        if "BINARY" in pardict:
            kind = pardict["BINARY"][0][0].upper()
            if kind not in BINARY_MODELS:
                raise TimingModelError(f"unknown binary model {kind!r}")
            comps.append(BINARY_MODELS[kind]())
        if (any(isinstance(c, Astrometry) for c in comps)
                and not any(isinstance(c, SolarSystemShapiro)
                            for c in comps)):
            comps.append(SolarSystemShapiro())
        return comps

    def __call__(self, par) -> TimingModel:
        """Parse and build: the par file's model, validated, its TZR
        arrival ingested."""
        pardict = parse_parfile(par)
        units = pardict.get("UNITS", [["TDB"]])[0][0].upper()
        if units not in ("TDB", "TCB"):
            raise TimingModelError(
                f"UNITS {units!r}: only TDB and TCB par files")
        model = TimingModel(components=self.choose_components(pardict))
        counters: dict[tuple[int, str], int] = {}
        unknown = {}
        for name, entries in pardict.items():
            if name in _IGNORE:
                continue
            if name == "UNITS":
                model.top_params[name] = _top_param(name, [units])
                continue
            if name in _TOP_STR + _TOP_FLOAT + _TOP_MJD:
                name = _TOP_ALIASES.get(name, name)
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
            warnings.warn(
                f"unrecognized par-file parameters {sorted(unknown)}",
                UnknownParameterWarning)
        model.unrecognized = unknown
        psr = model.top_params.get("PSR")
        model.name = psr.value if psr is not None else ""
        if units == "TCB":
            convert_tcb_tdb(model)
        model.setup()
        model.validate()
        _ingest_tzr_eagerly(model)
        return model


def _build(par) -> TimingModel:
    return ModelBuilder()(par)


def _top_param(name, tokens):
    if name in _TOP_MJD:
        p = MJDParameter(name)
    elif name in _TOP_FLOAT:
        p = floatParameter(name)
    else:
        p = strParameter(name, aliases=tuple(
            a for a, n in _TOP_ALIASES.items() if n == name))
    p.set_from_tokens(tokens)
    return p


# -- the parse cache of par text ---------------------------------------
# Identical par TEXT parsed again (a serving population past its records,
# repeated loads in analysis scripts) hits a content-hash cache: it holds
# a pristine clone of the built model and the parse's warnings; a hit
# replays the warnings and returns a fresh clone (parameter state copied,
# nothing parsed or validated), then ingests the TZR arrival anew under
# the environment in scope, as a build does.  Only multi-line strings are
# cached (a path's content can change on disk; a file object is
# consumed).  The variables of the data environment join the key, since
# the TZR deferral depends on them.
_PARSE_CACHE: OrderedDict = OrderedDict()  # guarded by _PARSE_CACHE_LOCK
_PARSE_CACHE_LOCK = lockwitness.wrap(threading.Lock(),
                                     "builder._PARSE_CACHE_LOCK")
#: the variables the ingest reads its clock files, EOP table, ephemeris
#: kernels, orbit tables and observatory overrides from
_PARSE_ENV_KEYS = ("PINT_TPU_CLOCK_DIR", "PINT_TPU_EOP", "PINT_TPU_EPHEM_DIR",
                   "PINT_TPU_ORBIT_DIR", "PINT_TPU_OBS_OVERRIDE")


def _parse_cache_size() -> int:
    """$PINT_TPU_TORCH_PARSE_CACHE=0 turns the cache off;
    $PINT_TPU_TORCH_PARSE_CACHE_SIZE bounds it (256 models)."""
    if os.environ.get("PINT_TPU_TORCH_PARSE_CACHE", "1") == "0":
        return 0
    try:
        return max(0, int(os.environ.get("PINT_TPU_TORCH_PARSE_CACHE_SIZE",
                                         "256")))
    except ValueError:
        return 256


def _parse_cache_key(par):
    if not isinstance(par, str) or "\n" not in par:
        return None
    env = tuple(os.environ.get(k, "") for k in _PARSE_ENV_KEYS)
    return hashlib.sha256(par.encode()).hexdigest(), env


def clear_parse_cache() -> None:
    """Drop every cached parse."""
    with _PARSE_CACHE_LOCK:
        _PARSE_CACHE.clear()


def get_model(par) -> TimingModel:
    """Par file (path, text or open file) -> validated TimingModel of the
    ported components; par text that was parsed before (in the same
    data environment) comes from the parse cache as a clone."""
    size = _parse_cache_size()
    key = _parse_cache_key(par) if size else None
    if key is not None:
        with _PARSE_CACHE_LOCK:
            hit = _PARSE_CACHE.get(key)
            if hit is not None:
                _PARSE_CACHE.move_to_end(key)
        if hit is not None:
            proto, caught = hit
            for w in caught:  # the par text's own warnings, replayed
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
            obs_metrics.counter("model.parse_cache_hits").inc()
            model = proto.clone()
            _ingest_tzr_eagerly(model)
            return model
    obs_metrics.counter("model.parses").inc()
    if key is None:
        return _build(par)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = _build(par)
    kept = []
    for w in caught:
        # the deferral is environment state, not par content: a hit
        # ingests anew and decides it afresh
        if not issubclass(w.category, TZRDeferredWarning):
            kept.append(w)
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    with _PARSE_CACHE_LOCK:
        _PARSE_CACHE[key] = (model.clone(), tuple(kept))
        _PARSE_CACHE.move_to_end(key)
        while len(_PARSE_CACHE) > size:
            _PARSE_CACHE.popitem(last=False)
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
