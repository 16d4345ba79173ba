"""Residuals: the host-facing view of a compiled model's residuals.

Counterpart of ``pint_tpu/residuals.py::Residuals`` (reference parity:
src/pint/residuals.py): phase and time residuals, chi2, degrees of
freedom and the weighted RMS at the model's current values, read off the
device as numpy or floats.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Residuals:
    """Residuals of ``model`` on ``toas`` at x = 0 (the model's current
    values).  ``compiled`` reuses a CompiledModel; otherwise the model is
    compiled on ``device`` (keyword-only; None: the CUDA card)."""

    def __init__(self, toas, model, subtract_mean: bool = True,
                 track_mode: Optional[str] = None, compiled=None, *,
                 device=None):
        self.toas = toas
        self.model = model
        self.cm = compiled or model.compile(toas, device=device,
                                            subtract_mean=subtract_mean)
        if track_mode is not None:
            self.cm.track_mode = track_mode
        self._x = self.cm.x0()

    @property
    def phase_resids(self) -> np.ndarray:
        return self.cm.phase_residuals(self._x).cpu().numpy()

    @property
    def time_resids(self) -> np.ndarray:
        """Seconds (weighted-mean-subtracted if subtract_mean)."""
        return self.cm.time_residuals(self._x).cpu().numpy()

    @property
    def chi2(self) -> float:
        return float(self.cm.chi2(self._x))

    @property
    def dof(self) -> int:
        # the implicit offset costs a dof unless PHOFF (already counted
        # among free params) replaces it
        offset = 0 if "PHOFF" in self.cm.free_names else 1
        return self.cm.bundle.ntoa - len(self.cm.free_names) - offset

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof

    def rms_weighted(self) -> float:
        """Weighted RMS of time residuals (scaled errors), seconds."""
        r = self.time_resids
        w = 1.0 / self.cm.scaled_sigma(self._x).cpu().numpy() ** 2
        return float(np.sqrt(np.sum(w * r * r) / np.sum(w)))


class CombinedResiduals:
    """Residual objects of independent data sets together (reference:
    residuals.py::CombinedResiduals): the chi2s and degrees of freedom
    add; each member keeps its own residuals and units."""

    def __init__(self, residual_list):
        self.residual_objs = list(residual_list)

    @property
    def chi2(self) -> float:
        return float(sum(r.chi2 for r in self.residual_objs))

    @property
    def dof(self) -> int:
        # a member without a dof raises AttributeError, never adds zero
        return int(sum(r.dof for r in self.residual_objs))

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof

    def __len__(self):
        return sum(len(getattr(r, "toas", [])) for r in self.residual_objs)
