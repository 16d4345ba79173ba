"""Fitters: WLS, GLS and their downhill variants.

Counterpart of ``pint_tpu/fitting/__init__.py`` without the wideband
fitters (ROADMAP A7).  Every fitter takes ``(toas, model)`` and
``device=None``, meaning the CUDA card.
"""

from pint_tpu_torch.fitting.downhill import (  # noqa: F401
    DownhillFitter,
    DownhillGLSFitter,
    DownhillWLSFitter,
)
from pint_tpu_torch.fitting.gls import GLSFitter  # noqa: F401
from pint_tpu_torch.fitting.utils import ftest  # noqa: F401
from pint_tpu_torch.fitting.wls import WLSFitter  # noqa: F401


def _is_wideband(toas) -> bool:
    """Whether every TOA of a host TOA table carries a wideband DM
    measurement (a ``pp_dm`` flag).  A device bundle carries no flags."""
    flags = toas.get("flags") if isinstance(toas, dict) else None
    return bool(flags) and all("pp_dm" in f for f in flags)


def auto_fitter(toas, model, downhill: bool = True, **kw):
    """Pick a fitter by model content, as the reference does: correlated
    noise -> GLS, else WLS; the downhill variants by default.  Wideband
    TOAs raise NotImplementedError (ROADMAP A7)."""
    if _is_wideband(toas):
        raise NotImplementedError(
            "wideband TOAs need the wideband fitters, which are not ported "
            "yet (ROADMAP A7)")
    correlated = any(
        c.introduces_correlated_errors for c in model.noise_components
    )
    if correlated:
        cls = DownhillGLSFitter if downhill else GLSFitter
    else:
        cls = DownhillWLSFitter if downhill else WLSFitter
    return cls(toas, model, **kw)
