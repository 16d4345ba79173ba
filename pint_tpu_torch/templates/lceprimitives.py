"""Energy-dependent light-curve primitives.

Counterpart of ``pint_tpu/templates/lceprimitives.py`` (reference
parity: src/pint/templates/lceprimitives.py, LCEGaussian and friends):
peak location and width drift with photon energy.  ``LCEPrimitive``
makes any 2-parameter base primitive energy-dependent with linear drifts
in ``u = log10(E / 1 GeV)``:

    width(u) = clip(width0 + width_slope * u, 1e-4, 0.5)
    loc(u)   = loc0 + loc_slope * u

The base primitive's formula is reused unchanged: its (width, loc)
scalars become per-photon tensors, which every elementwise primitive
broadcasts over.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.templates.lcprimitives import (
    LCPrimitive,
    as_tensor,
    host_tensor,
)


class LCEPrimitive:
    """Energy-dependent wrapper: params [width0, loc0, width_slope,
    loc_slope]; evaluation needs per-photon log10(E/GeV)."""

    n_params = 4
    is_energy_dependent = True

    def __init__(self, base: LCPrimitive, width_slope: float = 0.0,
                 loc_slope: float = 0.0):
        if base.n_params != 2:
            raise ValueError(
                "LCEPrimitive wraps 2-parameter (width, loc) "
                f"primitives; {type(base).__name__} has "
                f"{base.n_params}"
            )
        self.base = base
        self.params = np.array(
            [base.params[0], base.params[1], width_slope, loc_slope],
            dtype=np.float64,
        )

    @property
    def width(self):
        return self.params[0]

    @property
    def loc(self):
        return self.params[1]

    def __call__(self, phases, params=None, log10_ens=None):
        """Density at ``phases`` (and per-photon ``log10_ens``): a tensor
        of phases is evaluated on its device, numpy phases on the host,
        giving numpy."""
        if not isinstance(phases, torch.Tensor):
            u = None if log10_ens is None else host_tensor(log10_ens)
            return self(host_tensor(phases), params, u).numpy()
        p = self.params if params is None else params
        w0, l0, ws, ls = p[0], p[1], p[2], p[3]
        u = 0.0 if log10_ens is None else log10_ens
        w = torch.clamp(as_tensor(w0 + ws * u, phases), 1e-4, 0.5)
        loc = l0 + ls * u
        return self.base(phases, params=(w, loc))

    def fit_bounds(self):
        base = self.base.fit_bounds()
        # slopes unbounded; width positivity is enforced by the clip
        return base + [(None, None), (None, None)]

    def wrap_loc(self):
        self.params[1] = self.params[1] % 1.0

    def __repr__(self):
        return (
            f"LCEPrimitive({type(self.base).__name__}, "
            f"width={self.params[0]:.4f}+{self.params[2]:.4f}u, "
            f"loc={self.params[1]:.4f}+{self.params[3]:.4f}u)"
        )
