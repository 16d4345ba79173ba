"""Fitters: WLS, GLS, their downhill variants, the wideband fitters and
the scipy minimizers.

Counterpart of ``pint_tpu/fitting/__init__.py``.  Every fitter takes the
reference's positional parameters (``toas, model`` first) and a
keyword-only ``device=None``, meaning the CUDA card.
"""

from pint_tpu_torch.fitting.downhill import (  # noqa: F401
    DownhillFitter,
    DownhillGLSFitter,
    DownhillWLSFitter,
)
from pint_tpu_torch.fitting.gls import GLSFitter  # noqa: F401
from pint_tpu_torch.fitting.minimize import (  # noqa: F401
    MinimizeFitter,
    PowellFitter,
)
from pint_tpu_torch.fitting.utils import ftest  # noqa: F401
from pint_tpu_torch.fitting.wideband import (  # noqa: F401
    WidebandDownhillFitter,
    WidebandResiduals,
    WidebandTOAFitter,
)
from pint_tpu_torch.fitting.wls import WLSFitter  # noqa: F401
from pint_tpu_torch.toas.bundle import is_wideband


def auto_fitter(toas, model, downhill: bool = True, **kw):
    """Pick a fitter by the data and the model, as the reference does:
    wideband TOAs -> the wideband fitters; correlated noise -> GLS, else
    WLS; the downhill variants by default."""
    if is_wideband(toas):
        cls = WidebandDownhillFitter if downhill else WidebandTOAFitter
        return cls(toas, model, **kw)
    correlated = any(
        c.introduces_correlated_errors for c in model.noise_components
    )
    if correlated:
        cls = DownhillGLSFitter if downhill else GLSFitter
    else:
        cls = DownhillWLSFitter if downhill else WLSFitter
    return cls(toas, model, **kw)
