"""Shared fitter machinery.

Counterpart of ``pint_tpu/fitting/base.py``: the implicit offset column,
the Gauss-Newton iteration of ``make_scan_fit_loop``, here a Python loop
on the device with the same step semantics — the loop freezes on a
non-finite chi2 and stops when chi2 stops moving — and
``device_noise_floor``, the downhill fitters' per-iteration chi2 noise
floor computed on the device.  A frozen loop is refused by the fallback
ladder's validator (``runtime/fallback.py``), not here.  Every fitter's
``fit_toas`` runs under :func:`record_fit`: a ``fit`` span of the flight
recorder (the root the rung, compile, dispatch and fence spans nest
under), the ``fit.count`` counter and a reset of the log-dedup filter.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from pint_tpu_torch.device import F64
# ConvergenceFailure lives in exceptions.py; its old home keeps the name
from pint_tpu_torch.exceptions import ConvergenceFailure  # noqa: F401
from pint_tpu_torch.exceptions import DegeneracyWarning  # noqa: F401
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime.guard import check_deadlines


def record_fit(fit_fn):
    """Decorator for every fitter's ``fit_toas``: runs the body under the
    fit-level flight-recorder span (``Fitter._fit_obs_span``), so one fit
    produces a complete fit > rung > compile/dispatch > fence span tree,
    plus the always-on fit counter and the per-fit log-dedup reset."""

    @functools.wraps(fit_fn)
    def wrapped(self, *args, **kwargs):
        with self._fit_obs_span():
            return fit_fn(self, *args, **kwargs)

    return wrapped


def noffset(cm) -> int:
    """1 when the implicit offset column is in use; 0 when a free PHOFF
    replaces it."""
    return 0 if "PHOFF" in cm.free_names else 1


def design_with_offset(cm, x):
    """Design matrix with the implicit offset column prepended."""
    M = cm.design_matrix(x)
    if not noffset(cm):
        return M
    ones = torch.ones((cm.bundle.ntoa, 1), dtype=F64, device=M.device)
    return torch.cat([ones, M], dim=1)


def run_fit_loop(live_step, x0, p, maxiter, tol_chi2, init_chi2=None):
    """Iterate ``live_step(x) -> (x_new, (covn, norm), chi2, nbad)``, on
    the card a replay of the step's program (``CompiledModel.program``),
    whose outputs are copies the loop may keep across the next replay.

    Semantics of the reference's scan loop: each iteration takes the
    chi2 that ``live_step`` reports (GLS: the pre-step chi2 of the solve;
    WLS: ``cm.chi2`` at the new state) and applies the step; a non-finite
    chi2 freezes the state and ends the loop; |chi2_prev - chi2| < tol *
    max(chi2, 1) marks convergence after that step.  ``init_chi2(x0)``
    seeds chi2_prev (None: inf, so the first step always runs).  Returns
    (x, chi2, (covn, norm), converged, nbads, bad) with ``bad`` True when
    a chi2 was non-finite."""
    x = x0
    chi2_prev = math.inf if init_chi2 is None else float(init_chi2(x0))
    cov = (torch.zeros((p, p), dtype=F64, device=x0.device),
           torch.ones((p,), dtype=F64, device=x0.device))
    converged = False
    bad = False
    nbads = []
    for _ in range(maxiter):
        x_new, cov_new, chi2_t, nbad = live_step(x)
        # the one host read of an iteration: chi2 and nbad together,
        # after the step's deadline is kept (runtime/guard.py)
        check_deadlines(wait=True)
        chi2, nb = torch.stack([chi2_t.to(F64), nbad.to(F64)]).tolist()
        nbads.append(int(nb))
        if not math.isfinite(chi2):
            bad = True
            break
        conv = abs(chi2_prev - chi2) < tol_chi2 * max(chi2, 1.0)
        x, chi2_prev, cov = x_new, chi2, cov_new
        if conv:
            converged = True
            break
    return x, chi2_prev, cov, converged, nbads, bad


def device_noise_floor(lams, c):
    """The measured per-trial chi2 scatter at the current state, on the
    device: the twin of ``DownhillFitter._chi2_noise_floor`` that the
    fused downhill loop computes without a host round-trip.

    ``lams`` is the probe-lambda vector (probes + the lambda = 0
    baseline), ``c`` the matching chi2 trials (f64 tensors).  Degree-1
    least squares in closed form, with non-finite trials masked out of
    every sum and fewer than 4 finite points giving 0 — the host
    version's semantics (np.polyfit solves the same normal equations; the
    two agree to rounding, far below the floor's 6-sigma inflation)."""
    m = torch.isfinite(c)
    w = m.to(lams.dtype)
    cs = torch.where(m, c, torch.zeros_like(c))
    n = torch.sum(w)
    n_safe = torch.clamp(n, min=1.0)
    xm = torch.sum(w * lams) / n_safe
    ym = torch.sum(cs) / n_safe
    dxl = lams - xm
    sxx = torch.sum(w * dxl * dxl)
    sxy = torch.sum(w * dxl * (cs - ym))
    slope = sxy / torch.where(sxx > 0, sxx, torch.ones_like(sxx))
    resid = w * ((cs - ym) - slope * dxl)
    ss = torch.sum(resid * resid)
    dof = torch.clamp(n - 2.0, min=1.0)
    return torch.where(n >= 4.0, 6.0 * torch.sqrt(ss / dof),
                       torch.zeros_like(ss))


class Fitter:
    """Common base: compiled kernels + offset column + post-fit commit.
    Positional parameters are the reference's; ``device`` (None: the
    CUDA card) is keyword-only."""

    def __init__(self, toas, model, *, device=None):
        self.toas = toas
        self.model = model
        self.cm = model.compile(toas, device=device)
        self.device = self.cm.device
        self.converged = False
        self.parameter_covariance_matrix: np.ndarray | None = None
        self.chi2: float | None = None
        # which fallback-ladder rung served the last fit
        # (runtime/fallback.py::GuardReport; None before any fit)
        self.guard_report = None

    def _fit_obs_span(self):
        """Open the fit-level flight-recorder span, bump the fit counter,
        and reset the log-dedup filter so each fit's warnings print once
        per FIT, not once per process."""
        from pint_tpu_torch import logging as plog
        from pint_tpu_torch.obs import metrics as obs_metrics

        plog.reset_dedup()
        obs_metrics.counter("fit.count", help="fit_toas calls").inc()
        return TRACER.span(
            f"fit:{type(self).__name__}", "fit",
            free_params=len(self.cm.free_names),
            ntoa=self.cm.bundle.ntoa,
        )

    def flight_report(self) -> str:
        """Human post-mortem of the recorded flight (sibling of
        ``guard_report``): top spans, recompiles, bytes to device, rung
        history.  Metrics are always on; span detail appears when the
        recorder is enabled (obs.trace.enable() / $PINT_TPU_TRACE=1)."""
        from pint_tpu_torch.obs.export import flight_report

        return flight_report(guard_report=self.guard_report)

    def release(self) -> None:
        """Drop the step programs, and with them their CUDA graphs and
        memory pools; a later fit builds and captures them anew.  The
        programs otherwise live as long as the fitter, across commits
        (so a refit captures nothing), and a fitter is freed only when
        the garbage collector reaches it (its step functions refer back
        to it): release a fitter you are done with, as a loop over many
        pulsars would, to return its pools to the card at once."""
        self.cm.programs.clear()

    @property
    def _noffset(self) -> int:
        return noffset(self.cm)

    @staticmethod
    def _unnorm_cov(cov) -> np.ndarray:
        """(covn, norm) -> covn / outer(norm, norm) in host IEEE f64."""
        covn, norm = (c.detach().cpu().numpy() for c in cov)
        return covn / np.outer(norm, norm)

    def _finish_fit(self, result, warn_msg: str) -> float:
        """Commit a fit result the ladder's validator has accepted: one
        DegeneracyWarning per degenerate iteration, then the fitted
        deltas and uncertainties into the host parameters."""
        x, chi2, cov, conv, nbads, _bad = result
        for nb in nbads:
            if nb > 0:
                warnings.warn(f"{nb} {warn_msg}", DegeneracyWarning)
        self.converged = bool(conv)
        return self._finalize(x, cov, chi2)

    def _finalize(self, x, cov, chi2) -> float:
        """Drop the offset row and column, commit the fitted deltas and
        uncertainties into the host parameters, record chi2."""
        # explicit device fence of the result (a recorded span when
        # tracing): nothing below may commit values still being computed
        x, cov = TRACER.fence((x, cov), name="fit-result")
        no = self._noffset
        cov = self._unnorm_cov(cov)[no:, no:]
        sigmas = np.sqrt(np.diag(cov))
        self.parameter_covariance_matrix = cov
        self.cm.commit(x.detach().cpu().numpy(), uncertainties=sigmas)
        self.chi2 = float(chi2)
        return self.chi2

    @property
    def resids(self):
        """Residuals at the model's current values (after a fit, the
        fitted ones); the wideband fitters return their paired
        residuals."""
        from pint_tpu_torch.residuals import Residuals

        return Residuals(self.toas, self.model, compiled=self.cm)

    def get_derived_params(self) -> str:
        """Derived quantities of the (fitted) model, as text: spin
        period, characteristic age, surface B field, spin-down luminosity,
        and the binary mass function when the model has an orbit
        (reference: src/pint/fitter.py::Fitter.get_derived_params)."""
        from pint_tpu_torch import derived_quantities as dq

        m = self.model
        lines = []

        def _val(name):
            p = m.params.get(name)
            if p is None or p.value is None:
                return None
            v = p._par_value()
            return float(v.to_float()) if hasattr(v, "to_float") else float(v)

        f0, f1 = _val("F0"), _val("F1")
        if f0:
            p0, p1 = dq.p_to_f(f0, f1 or 0.0)  # involution: f->p too
            lines.append(f"P0 = {p0:.15g} s")
            if f1:
                lines.append(f"P1 = {p1:.6g}")
                lines.append(
                    f"tau_c = {dq.pulsar_age(f0, f1):.4g} yr"
                )
                lines.append(f"B_surf = {dq.pulsar_B(f0, f1):.4g} G")
                lines.append(
                    f"Edot = {dq.pulsar_edot(f0, f1):.4g} erg/s"
                )
        pb, a1 = _val("PB"), _val("A1")
        if pb is None and _val("FB0"):
            pb = 1.0 / _val("FB0") / 86400.0
        if pb and a1:
            mf = dq.mass_funct(pb * 86400.0, a1)
            lines.append(f"mass function = {mf:.6g} Msun")
            lines.append(
                "companion mass (i=60deg, mp=1.4) = "
                f"{dq.companion_mass(pb * 86400.0, a1):.4g} Msun"
            )
        return "\n".join(lines)

    def print_summary(self) -> str:
        """Print and return the fit summary: chi2, dof, weighted RMS, each
        free parameter's value and uncertainty, and the derived
        quantities (the reference's text, string for string)."""
        resids = self.resids
        chi2 = self.chi2 if self.chi2 is not None else resids.chi2
        lines = [
            f"Fitted model using {type(self).__name__} with "
            f"{len(self.cm.free_names)} free parameters, "
            f"{self.cm.bundle.ntoa} TOAs; converged={self.converged}",
            f"chi2 = {chi2:.4f}",
        ]
        dof = getattr(resids, "dof", None)
        if dof is not None:
            lines.append(
                f"dof = {dof}  reduced chi2 = {chi2 / dof:.4f}"
            )
        if hasattr(resids, "rms_weighted"):
            lines.append(
                f"weighted RMS = {resids.rms_weighted() * 1e6:.4f} us"
            )
        lines.append(
            f"{'PARAM':<12}{'VALUE':>25}{'UNCERTAINTY':>15}"
        )
        for n in self.cm.free_names:
            p = self.model.params[n]
            unc = p.uncertainty if p.uncertainty is not None else float("nan")
            lines.append(f"{n:<12}{p._format_value():>25}{unc:>15.3e}")
        derived = self.get_derived_params()
        if derived:
            lines.append("Derived Parameters:")
            lines.append(derived)
        out = "\n".join(lines)
        print(out)
        return out
