"""Wideband fitters: joint TOA + DM-measurement fitting.

Counterpart of ``pint_tpu/fitting/wideband.py``.  Wideband TOAs carry a
DM measurement each (``pp_dm`` / ``pp_dme`` flags, or ``dm_meas`` /
``dm_err`` columns of the table); the fit minimizes the joint chi2 of

    r = [ time residuals (n,) ; DM residuals (n,) ]

under the block covariance C = blockdiag(N_toa + T phi T^T, D_dm), D_dm
the diagonal DMEFAC/DMEQUAD-scaled DM variances.  The combined residual
is one function of x, so its design matrix is one ``torch.func.jacfwd``
and the DM-carrying parameters (DM, DMX, DMJUMP, NE_SW) get rows in both
blocks.  The basis rows of the DM block are zero.

``WidebandTOAFitter`` subclasses ``GLSFitter`` through its three step
hooks, so the mixed step on the card takes the stacked 2n rows through
the joint-Gram kernel (``ops/fused_gram.py``); the streaming-basis
(fourier) step does not apply, because its basis rows are TOA-indexed.
``WidebandDownhillFitter`` is the step-halving fitter over the same
stacked system.  With ``full_cov=True`` both take the dense step
(``gls_step_full_cov``) over the 2n stacked rows, the downhill fitter for
its proposal only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.fitting.downhill import DownhillFitter, _proposal_step
from pint_tpu_torch.fitting.gls import GLSFitter, make_cinv_mult
from pint_tpu_torch.toas.bundle import get_dm_measurements, is_wideband


class WidebandResiduals:
    """Paired TOA and DM residuals of a compiled wideband model at x
    (the reference model by default)."""

    def __init__(self, cm, x=None):
        self.cm = cm
        self._x = cm.x0() if x is None else x

    @property
    def toa_resids(self) -> np.ndarray:
        """Time residuals (s), weighted-mean subtracted."""
        return self.cm.time_residuals(self._x).detach().cpu().numpy()

    @property
    def dm_resids(self) -> np.ndarray:
        """DM residuals, measured minus model (pc cm^-3)."""
        return self.cm.dm_residuals(self._x).detach().cpu().numpy()

    @property
    def toa_chi2(self) -> float:
        return float(self.cm.chi2(self._x))

    @property
    def dm_chi2(self) -> float:
        r = self.cm.dm_residuals(self._x)
        s = self.cm.scaled_dm_sigma(self._x)
        return float(torch.sum(torch.square(r / s)))

    @property
    def chi2(self) -> float:
        return self.toa_chi2 + self.dm_chi2


def _validate_wideband(toas) -> None:
    """Refuse TOAs that are not all wideband, or whose DM errors are
    missing or not positive."""
    if not is_wideband(toas):
        raise PintTpuError(
            "wideband fitter requires -pp_dm flags on every TOA"
        )
    _, dme = get_dm_measurements(toas)
    bad = ~np.isfinite(dme) | (dme <= 0)
    if bad.any():
        raise PintTpuError(
            f"{int(bad.sum())} TOAs have missing/invalid -pp_dme DM "
            "uncertainties (first at index "
            f"{int(np.flatnonzero(bad)[0])})"
        )


class _WidebandKernels:
    """The stacked [TOA; DM] residuals, design matrix and noise, shared
    by both wideband fitters (a mixin over a Fitter: ``self.cm``,
    ``self._noffset``)."""

    @property
    def resids(self) -> WidebandResiduals:
        """The paired residuals at the model's current values."""
        return WidebandResiduals(self.cm)

    def _combined_residuals(self, x):
        return torch.cat([self.cm.time_residuals(x, subtract_mean=False),
                          self.cm.dm_residuals(x)])

    def _offset_column(self):
        """1 on the TOA rows, 0 on the DM rows: a phase offset does not
        move DM."""
        n = self.cm.bundle.ntoa
        dev = self.cm.device
        return torch.cat([torch.ones(n, dtype=F64, device=dev),
                          torch.zeros(n, dtype=F64, device=dev)])

    def _combined_design(self, x):
        """(2n, p [+ 1]) jacfwd design matrix, the offset column first."""
        M = jacfwd(self._combined_residuals)(x)
        if not self._noffset:
            return M
        return torch.cat([self._offset_column()[:, None], M], dim=1)

    def _combined_ndiag(self, x):
        """(2n,) stacked variances [white TOA; DM]."""
        return torch.cat([torch.square(self.cm.scaled_sigma(x)),
                          torch.square(self.cm.scaled_dm_sigma(x))])

    def _combined_basis(self, x):
        """(2n, k) basis and (k,) weights: the correlated bases act on the
        TOA block only."""
        Tt, phi = self.cm.noise_basis_or_empty(x)
        T = torch.cat([Tt, torch.zeros_like(Tt)], dim=0)
        return T, phi

    def _combined_noise(self, x):
        """(Ndiag (2n,), T (2n, k), phi (k,))."""
        T, phi = self._combined_basis(x)
        return self._combined_ndiag(x), T, phi


class WidebandTOAFitter(_WidebandKernels, GLSFitter):
    """Iterated joint GLS over the [TOA; DM] blocks with GLSFitter's
    policy, ladder and modes ('auto' takes the mixed step on the card,
    whose joint Gram is the CUDA kernel over the 2n stacked rows)."""

    def __init__(self, toas, model, full_cov: bool = False, fused="auto", *,
                 device=None):
        _validate_wideband(toas)
        if fused is True:
            # the streaming kernel generates TOA-indexed basis rows; the
            # wideband system has stacked [TOA; DM] rows
            raise PintTpuError(
                "the Pallas pure-Fourier path (fused=True) does not "
                "apply to wideband's stacked [TOA; DM] system; use "
                "fused='mixed' to force the mixed-precision MXU path"
            )
        super().__init__(toas, model, full_cov, fused, device=device)

    def _fourier_available(self) -> bool:
        return False

    def _step_inputs(self, x):
        return (self._combined_residuals(x), self._combined_design(x),
                self._combined_ndiag(x))

    def _step_noise(self, x):
        return self._combined_basis(x)


class WidebandDownhillFitter(_WidebandKernels, DownhillFitter):
    """Step-halving wideband fitter: DownhillGLSFitter's proposals (mixed
    on the card for a model with correlated noise, the dense step with
    ``full_cov=True``, all-f64 on the CPU and on the fallback rung) over
    the stacked rows; the objective is the stacked GLS chi2 with the
    offset profiled out over the TOA rows."""

    def __init__(self, toas, model, full_cov: bool = False, *, device=None):
        _validate_wideband(toas)
        super().__init__(toas, model, device=device)
        self.full_cov = full_cov

    def _make_proposal(self, force_f64: bool = False):
        noffset = self._noffset
        step = _proposal_step(self.cm, self.full_cov, force_f64)

        def proposal(x):
            r = self._combined_residuals(x)
            M = self._combined_design(x)
            Ndiag, T, phi = self._combined_noise(x)
            dx, cov, _, nbad = step(r, M, Ndiag, T, phi,
                                    normalized_cov=True)
            # the quadratic model's predicted decrease: dx . (-M^T C^-1 r)
            Cir = make_cinv_mult(Ndiag, T, phi)(r[:, None])[:, 0]
            pred = -torch.dot(dx, M.T @ Cir)
            return dx[noffset:], cov, nbad, pred

        return proposal

    def _make_chi2(self):
        def chi2(x):
            r = self._combined_residuals(x)
            Ndiag, T, phi = self._combined_noise(x)
            cinv_mult = make_cinv_mult(Ndiag, T, phi)
            Cir = cinv_mult(r[:, None])[:, 0]
            c2 = torch.dot(r, Cir)
            if self._noffset:
                u = self._offset_column()
                Ciu = cinv_mult(u[:, None])[:, 0]
                c2 = c2 - torch.dot(u, Cir) ** 2 / torch.dot(u, Ciu)
            return c2

        return chi2
