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
    """Base: ordered parameter container."""

    category: Optional[str] = None

    def __init__(self):
        self.params: dict[str, Parameter] = {}

    def add_param(self, par: Parameter) -> Parameter:
        self.params[par.name] = par
        return par

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
        """Raise on ill-formed input."""

    def require(self, *names):
        for n in names:
            p = self.params.get(n)
            if p is None or p.value is None:
                raise ValueError(f"{type(self).__name__} needs {n}")

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
        for p in self.params.values():
            if p.name_matches(name):
                return p
        return self.new_prefix_param(name)

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
