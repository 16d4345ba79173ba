"""Component base classes.

Counterpart of ``pint_tpu/models/component.py``: a component is a host
bag of Parameters plus pure kernel functions.  Kernel methods receive

  pdict   dict param-name -> f64 tensor scalar, DD scalar, or epoch
          (day, DD seconds)
  bundle  TOABundle (tensors on the model's device)

and return tensors.  Mask parameters become static 0/1 columns in the
bundle, computed on the host at compile time.
"""

from __future__ import annotations

from typing import Optional

from pint_tpu_torch.exceptions import MissingParameter
from pint_tpu_torch.models.parameter import Parameter, maskParameter

# category evaluation order for delays/phases: the JAX package's
# DEFAULT_ORDER (each delay component sees the delay accumulated by the
# ones before it, so the binary, "pulsar_system", sees astrometry,
# Shapiro, DM, DMX and FD)
DEFAULT_ORDER = [
    "astrometry",
    "jump_delay",
    "troposphere",
    "solar_system_shapiro",
    "solar_wind",
    "dispersion_constant",
    "dispersion_dmx",
    "chromatic",
    "frequency_dependent",
    "pulsar_system",
    "spindown",
    "phase_jump",
    "wave",
    "ifunc",
    "glitch",
    "piecewise_spindown",
    "absolute_phase",
    "phase_offset",
]


class Component:
    """Base: ordered parameter container with a class registry: every
    subclass that sets ``register = True`` (or inherits it) is listed in
    ``Component.component_types`` by class name, which the model builder
    chooses from."""

    register = False
    category: Optional[str] = None
    component_types: dict = {}
    #: indexed parameter families (F#, DMX_####, ...) by prefix
    prefix_patterns: tuple = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("register", cls.register):
            Component.component_types[cls.__name__] = cls

    def __init__(self):
        self.params: dict[str, Parameter] = {}

    def add_param(self, par: Parameter) -> Parameter:
        self.params[par.name] = par
        return par

    def __getattr__(self, name):
        params = object.__getattribute__(self, "__dict__").get("params", {})
        if name in params:
            return params[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute/parameter {name!r}"
        )

    def has_param(self, name: str) -> bool:
        return name in self.params

    def match_param_alias(self, name: str) -> Optional[str]:
        """Resolve an alias to this component's canonical param name."""
        for p in self.params.values():
            if p.name_matches(name):
                return p.name
        return None

    @property
    def free_params(self) -> list[str]:
        return [
            n for n, p in self.params.items()
            if not p.frozen and p.value is not None
        ]

    @property
    def mask_params(self) -> list[str]:
        return [
            n for n, p in self.params.items() if isinstance(p, maskParameter)
        ]

    def setup(self, model):
        """Called once after all parameters are set."""

    def validate(self, model):
        """Raise TimingModelError / MissingParameter on ill-formed input."""

    def require(self, *names):
        for n in names:
            p = self.params.get(n)
            if p is None or p.value is None:
                raise MissingParameter(type(self).__name__, n)

    def anchors(self) -> dict:
        """Host values the kernels are taken about, as ``{pdict key:
        (value, ...)}``; CompiledModel puts them in the parameter dict as
        device scalars (``timing_model.py::device_anchors``), so a PTA
        batch carries each pulsar's own."""
        return {}

    def host_state(self) -> tuple:
        """Host parameter values the kernels read at call time, other
        than through the parameter dict: a PTA batch refuses pulsars
        whose host states differ (``parallel/pta.py``)."""
        return ()

    def mask_families(self) -> dict:
        """prefix -> factory(index) for repeated par lines (EFAC, ...)."""
        return {}

    def new_prefix_param(self, name: str):
        """A Parameter for an indexed-family name not yet instantiated
        (DMX_0017, FB3, ...), or None if this component has no such
        family."""
        return None

    def ensure_param(self, name: str):
        """The Parameter this component holds for par name ``name``
        (aliases included), freshly made for an indexed family, or
        None."""
        canon = self.match_param_alias(name)
        if canon is not None:
            return self.params[canon]
        return self.new_prefix_param(name)

    @classmethod
    def accepted_param_names(cls) -> set[str]:
        """All par-file names (aliases included, prefix indices not) this
        component understands."""
        proto = cls()
        names = set()
        for p in proto.params.values():
            names.add(p.name.upper())
            names.update(a.upper() for a in p.aliases)
        for pref in proto.prefix_patterns:
            names.add(pref.upper() + "#")
        names.update(k.upper() for k in proto.mask_families())
        return names

    def remove_param(self, name: str):
        self.params.pop(name, None)

    def __repr__(self):
        ps = ", ".join(
            f"{n}={p.value}" for n, p in self.params.items()
            if p.value is not None
        )
        return f"{type(self).__name__}({ps})"


class DelayComponent(Component):
    """Contributes seconds of delay, evaluated in category order."""

    def delay_term(self, pdict, bundle, acc_delay):
        raise NotImplementedError


class PhaseComponent(Component):
    """Contributes pulse phase (DD cycles) at t - total_delay."""

    def phase_term(self, pdict, bundle, delay):
        raise NotImplementedError


class NoiseComponent(Component):
    """Modifies TOA uncertainties / contributes covariance bases."""

    introduces_correlated_errors = False

    def scaled_sigma(self, pdict, bundle, sigma_s):
        return sigma_s

    def basis_weight(self, pdict, bundle):
        return None
