"""Light-curve primitives: periodic unit-normalized peak shapes.

Counterpart of ``pint_tpu/templates/lcprimitives.py`` (reference parity:
src/pint/templates/lcprimitives.py::LCGaussian, LCVonMises): each
primitive is a density on phase [0, 1) with parameters (width, location).
``__call__`` computes on the device of a tensor of phases (numpy phases
on the host, giving numpy); the parameters are the primitive's own
(numpy) or a tensor slice of a template's parameter vector, which
gradients flow through.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.ops.interp import interp

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor, a number or a numpy value) as an f64 tensor on
    ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v, dtype=np.float64),
                           device=like.device)


def host_tensor(a) -> torch.Tensor:
    """Host data (numpy or numbers) as an f64 CPU tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class LCPrimitive:
    """Base: params [width, loc]; density integrates to 1 over a cycle."""

    n_params = 2

    def __init__(self, width: float = 0.03, loc: float = 0.5):
        self.params = np.array([width, loc], dtype=np.float64)

    def __call__(self, phases, params=None):
        """Density at ``phases``: a tensor is evaluated on its device and
        gives a tensor; numpy phases are host data and give numpy."""
        if not isinstance(phases, torch.Tensor):
            return self._density(host_tensor(phases), params).numpy()
        return self._density(phases, params)

    def _density(self, phases, params):
        raise NotImplementedError

    def _wl(self, params):
        return ((self.params[0], self.params[1]) if params is None
                else (params[0], params[1]))

    @property
    def loc(self):
        return self.params[1]

    @property
    def width(self):
        return self.params[0]

    def fit_bounds(self):
        """L-BFGS-B bounds per parameter: positive width, free loc."""
        return [(1e-4, 0.5), (None, None)]

    is_energy_dependent = False

    def wrap_loc(self):
        """Fold the fitted location into [0, 1) (the loc slot is the
        LAST parameter for every base primitive; energy-dependent
        wrappers override)."""
        self.params[-1] = self.params[-1] % 1.0

    def __repr__(self):
        return (
            f"{type(self).__name__}(width={self.params[0]:.4f}, "
            f"loc={self.params[1]:.4f})"
        )


class LCGaussian(LCPrimitive):
    """Wrapped Gaussian peak (summed over +-2 neighbor cycles — ample
    for widths < 0.2 cycles)."""

    def _density(self, phases, params):
        w, loc = self._wl(params)
        dphi = phases - loc
        out = 0.0
        for k in (-2, -1, 0, 1, 2):
            z = (dphi + k) / w
            out = out + torch.exp(-0.5 * z * z)
        return out / (w * _SQRT_2PI)


class LCVonMises(LCPrimitive):
    """Von Mises peak; width parameter = 1/sqrt(kappa) (sigma-like)."""

    def _density(self, phases, params):
        w, loc = self._wl(params)
        kappa = as_tensor(1.0 / (w * w), phases)
        z = 2.0 * math.pi * (phases - loc)
        # angle density exp(kappa cos z) / (2 pi I0(kappa)) times the
        # dtheta/dphi = 2 pi Jacobian: a per-cycle density
        return torch.exp(kappa * (torch.cos(z) - 1.0)) / torch.special.i0e(
            kappa)


class LCLorentzian(LCPrimitive):
    """Wrapped Cauchy (Lorentzian) peak (reference:
    lcprimitives.py::LCLorentzian).  width = HWHM gamma in cycles;
    density in phase: (1-rho^2)/(1+rho^2-2 rho cos(2 pi dphi)) with
    rho = exp(-2 pi gamma)."""

    def _density(self, phases, params):
        w, loc = self._wl(params)
        rho = torch.exp(-2.0 * math.pi * as_tensor(w, phases))
        z = 2.0 * math.pi * (phases - loc)
        return (1.0 - rho * rho) / (
            1.0 + rho * rho - 2.0 * rho * torch.cos(z)
        )


class LCGaussian2(LCPrimitive):
    """Two-sided (asymmetric) Gaussian peak (reference:
    lcprimitives.py::LCGaussian2): width1 on the leading (dphi < 0)
    side, width2 trailing, continuous at the peak; params
    [width1, width2, loc]."""

    n_params = 3

    def __init__(self, width: float = 0.03, width2: float = 0.03,
                 loc: float = 0.5):
        self.params = np.array([width, width2, loc], dtype=np.float64)

    @property
    def loc(self):
        return self.params[2]

    def fit_bounds(self):
        return [(1e-4, 0.5), (1e-4, 0.5), (None, None)]

    def _density(self, phases, params):
        w1, w2, loc = (
            tuple(self.params) if params is None
            else (params[0], params[1], params[2])
        )
        w1, w2 = as_tensor(w1, phases), as_tensor(w2, phases)
        norm = 2.0 / (_SQRT_2PI * (w1 + w2))
        dphi = phases - loc
        out = 0.0
        for k in (-2, -1, 0, 1, 2):
            d = dphi + k
            w = torch.where(d < 0, w1, w2)
            z = d / w
            out = out + torch.exp(-0.5 * z * z)
        return norm * out

    def __repr__(self):
        return (
            f"LCGaussian2(width={self.params[0]:.4f}, "
            f"width2={self.params[1]:.4f}, loc={self.params[2]:.4f})"
        )


class LCBinnedProfile(LCPrimitive):
    """Empirical binned profile (a .prof file) as a primitive: periodic
    linear interpolation of a normalized histogram (``ops/interp.py``,
    ``jnp.interp``'s formula); the only live parameter is the phase
    shift (params [scale (unused), loc] to keep the (width, loc)
    layout)."""

    def __init__(self, values, loc: float = 0.0):
        vals = np.asarray(values, dtype=np.float64)
        if vals.ndim != 1 or len(vals) < 4:
            raise ValueError("binned profile needs a 1-D array (>=4 bins)")
        if np.any(vals < 0):
            vals = vals - vals.min()  # raw profiles may ride a baseline
        if not np.isfinite(vals).all() or vals.mean() <= 0:
            # mirrors read_prof's 'profile is constant' guard
            raise ValueError(
                "binned profile is empty or constant (zero mean after "
                "baseline subtraction)"
            )
        self.values = vals / vals.mean()  # unit mean = unit integral
        self.params = np.array([1.0, loc], dtype=np.float64)

    def fit_bounds(self):
        # the scale slot is structural, not a shape parameter: pin it
        return [(1.0, 1.0), (None, None)]

    def _density(self, phases, params):
        loc = self.params[1] if params is None else params[1]
        nb = len(self.values)
        # bin centers at (i + 0.5)/nb; wrap by padding one bin each side
        grid = (np.arange(nb + 2) - 0.5) / nb
        vals = np.concatenate([
            self.values[-1:], self.values, self.values[:1]
        ])
        x = torch.remainder(phases - loc, 1.0)
        return interp(x, grid, vals)
