"""Pulse-profile templates + photon-phase maximum-likelihood fitting.

Counterpart of ``pint_tpu/templates/`` (reference parity:
src/pint/templates/: lctemplate.py, lcprimitives.py, lcfitters.py;
heritage Fermi pointlike): analytic profile templates as weighted sums
of periodic primitives plus an unpulsed background, fitted to photon
phases by maximum likelihood.  The densities are torch functions of the
parameter vector, evaluated where the phases lie (the fitter puts them
on the card by default); the fitter is scipy L-BFGS-B on the host with
``torch.autograd`` gradients and a ``torch.func.hessian`` for the
errors.
"""

from pint_tpu_torch.templates.lcprimitives import (  # noqa: F401
    LCBinnedProfile,
    LCGaussian,
    LCGaussian2,
    LCLorentzian,
    LCVonMises,
)
from pint_tpu_torch.templates.lceprimitives import LCEPrimitive  # noqa: F401
from pint_tpu_torch.templates.lctemplate import LCTemplate  # noqa: F401
from pint_tpu_torch.templates.lcfitters import LCFitter  # noqa: F401
from pint_tpu_torch.templates.lcio import (  # noqa: F401
    read_gauss,
    read_prof,
    read_template,
    write_gauss,
    write_prof,
)
