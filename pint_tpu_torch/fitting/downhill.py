"""Downhill (step-halving) fitters.

Counterpart of ``pint_tpu/fitting/downhill.py``, decision for decision:
propose a full Gauss-Newton step, evaluate chi2 along a static ladder of
step lengths lambda, take the largest lambda that does not raise chi2
beyond the tolerance plus a measured noise floor; warn and keep the
best-known solution when no lambda is acceptable; raise
InvalidModelParameters on a non-finite start.

The fused loop (``_fused_loop``) keeps every decision on the device: the
whole lambda ladder — 10 trials, 4 noise-floor probes and the lambda = 0
baseline — is one batched chi2 evaluation (``torch.func.vmap`` of the
fitter's chi2), and the noise floor, the accept/reject choice and the
stop/convergence flags are tensors (``torch.where``, ``argmax``).  The
host reads one bool per iteration, ``done``.  The reference's host loop
survives as ``_fit_toas_host``: the fault ladder's last rung and the
``PINT_TPU_TORCH_DOWNHILL_FUSED=0`` escape hatch (read at every call).
It runs the same proposals and the same batched ladder on the same
device, and makes its decisions on the host.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from torch.func import vmap

from pint_tpu_torch.exceptions import (
    ConvergenceWarning,
    CorrelatedErrors,
    GuardTripWarning,
    InvalidModelParameters,
    PintTpuNumericsError,
)
from pint_tpu_torch.fitting.base import (
    DegeneracyWarning,
    Fitter,
    design_with_offset,
    device_noise_floor,
)
from pint_tpu_torch.fitting.gls import (
    default_accel_mode,
    gls_step_full_cov,
    gls_step_woodbury,
    gls_step_woodbury_mixed,
    make_cinv_mult,
)
from pint_tpu_torch.fitting.wls import _wls_step, default_wls_method
from pint_tpu_torch.runtime.fallback import GuardReport, run_ladder
from pint_tpu_torch.runtime.guard import validate_finite

F64 = torch.float64


def _ladder_lams(min_lambda: float):
    """The static lambda ladder and measurement probes shared by the
    fused loop and the host loop.

    The trials are 1, 1/2, ... down to ``min_lambda``; the acceptance
    rule picks the largest acceptable one, the reference's sequential
    first-accept.  The probes are measurement-only lambdas below
    ``min_lambda``, short enough that the true chi2 change is linear in
    lambda, so their deviation from a straight line measures the chi2
    evaluation's scatter.  They are fixed small values, except when the
    fixed list would only partly survive (min_lambda in (6.25e-5, 5e-4]);
    then the whole set scales with ``min_lambda``.  The trailing
    lambda = 0 entry is the baseline every accept/reject compares with,
    evaluated in the same batched call as the trials.

    Returns (lams, probe_lams, all_lams) with
    all_lams = lams + probe_lams + [0.0] as a host array."""
    lams = []
    lam = 1.0
    while lam >= min_lambda:
        lams.append(lam)
        lam *= 0.5
    probe_lams = [
        s for s in (5e-4, 2.5e-4, 1.25e-4, 6.25e-5) if s < min_lambda
    ]
    if len(probe_lams) < 4:
        probe_lams = [min_lambda * f for f in (0.5, 0.25, 0.125, 0.0625)]
    all_lams = np.asarray(lams + probe_lams + [0.0])
    return lams, probe_lams, all_lams


class DownhillFitter(Fitter):
    """Base downhill fitter: subclasses provide ``_make_proposal``
    (x -> (dx, cov, nbad, predicted_decrease)) and ``_make_chi2`` (the
    offset-profiled objective x -> chi2)."""

    # subclasses override ------------------------------------------------
    def _make_proposal(self, force_f64: bool = False):
        """Proposal ``x -> (dx, cov, nbad, pred)``; ``force_f64=True`` is
        the guard's fallback rung — the all-f64 step on subclasses whose
        native proposal is mixed-precision (the same step otherwise)."""
        raise NotImplementedError

    def _make_chi2(self):
        """Offset-profiled objective ``x -> chi2``."""
        raise NotImplementedError

    def _make_ladder(self, chi2_fn, all_lams):
        """(x, dx) -> chi2 at x + lam dx for every lam of ``all_lams``,
        in one batched evaluation."""
        lams_t = torch.as_tensor(all_lams, dtype=F64, device=self.device)
        batched = vmap(chi2_fn)

        def ladder(x, dx):
            return batched(x[None, :] + lams_t[:, None] * dx[None, :])

        return ladder, lams_t

    def _guarded_proposal(self, proposal, x, fell_back: bool):
        """Run and validate one host-loop proposal.  A non-finite proposal
        falls back once to the all-f64 step (the chi2 ladder downstream
        still gates every step).  Returns
        (dx, cov, nbad, pred, proposal, fell_back)."""
        site = f"downhill:{type(self).__name__}/proposal"
        backend = self.device.type
        dx, cov, nbad, pred = proposal(x)
        try:
            validate_finite({"dx": dx, "pred": pred}, site=site,
                            what="downhill proposal", backend=backend)
        except PintTpuNumericsError:
            if fell_back:
                raise
            warnings.warn(
                "downhill proposal produced non-finite values; "
                "falling back to the all-f64 proposal step",
                GuardTripWarning,
            )
            proposal = self._make_proposal(force_f64=True)
            fell_back = True
            dx, cov, nbad, pred = proposal(x)
            validate_finite({"dx": dx, "pred": pred},
                            site=site + "/rung:f64",
                            what="downhill proposal", backend=backend)
        return dx, cov, nbad, pred, proposal, fell_back

    # --------------------------------------------------------------------
    @staticmethod
    def _chi2_noise_floor(lams, c_tries) -> float:
        """The measured per-trial chi2 noise floor at the current state:
        six times the scatter of the probe trials (and the lambda = 0
        baseline) about a straight line in lambda.  Accept/reject
        decisions below it are coin flips.  The fused loop computes the
        same fit on the device (``fitting/base.py::device_noise_floor``)."""
        lams = np.asarray(lams, dtype=float)
        c = np.asarray(c_tries, dtype=float)
        ok = np.isfinite(c)
        if int(np.sum(ok)) < 4:
            return 0.0
        ls, cs = lams[ok], c[ok]
        coef = np.polyfit(ls, cs, 1)
        resid = cs - np.polyval(coef, ls)
        return 6.0 * float(np.sqrt(np.sum(resid**2) / (len(ls) - 2)))

    # -- the fused loop -------------------------------------------------
    def _make_iteration(self, force_f64: bool, required_chi2_decrease: float,
                        max_chi2_increase: float, min_lambda: float):
        """One fused iteration as a function of tensors,
        ``(x, chi2, bad_prop, bad_base) -> (x, chi2, conv, step_problem,
        pred, floor, bad_prop, bad_base, done, nbad)``: the proposal, the
        batched lambda ladder, the noise floor and the accept/stop/freeze
        logic, with no host read.  -> (iteration, proposal, chi2_fn)."""
        # no-argument call on the native rung: the proposal maker is the
        # overridable surface
        proposal = (self._make_proposal(force_f64=True) if force_f64
                    else self._make_proposal())
        chi2_fn = self._make_chi2()
        lams, _probe_lams, all_lams = _ladder_lams(min_lambda)
        nlam = len(lams)
        ladder, lams_t = self._make_ladder(chi2_fn, all_lams)
        probe_t = lams_t[nlam:]

        def iteration(x, chi2c, badp, badb):
            dx, _cov, nbad, pred = proposal(x)
            prop_ok = torch.all(torch.isfinite(dx)) & torch.isfinite(pred)
            c_all = ladder(x, dx)
            base = c_all[-1]
            base_ok = torch.isfinite(base)
            floor = device_noise_floor(probe_t, c_all[nlam:])
            c_tries = c_all[:nlam]
            okm = torch.isfinite(c_tries) & (
                c_tries < base + max_chi2_increase + floor)
            # first True = the largest acceptable lambda (host order);
            # gathered by a 1-element index, as a 0-d index is read on
            # the host
            idx = torch.argmax(okm.to(torch.int32)).reshape(1)
            any_ok = torch.any(okm) & prop_ok & base_ok
            c_new = c_tries.index_select(0, idx)[0]
            tol = torch.clamp(floor, min=required_chi2_decrease)
            small = torch.abs(base - c_new) < tol
            hazard = ~prop_ok | ~base_ok
            # no acceptable step: a large unrealized predicted decrease is
            # a step problem, a sub-floor one is silent convergence
            sp = ~any_ok & ~hazard & (pred > tol)
            conv = torch.where(any_ok, small, ~sp & ~hazard)
            done = ~any_ok | small
            x = torch.where(any_ok, x + lams_t.index_select(0, idx) * dx, x)
            chi2c = torch.where(any_ok, c_new,
                                torch.where(hazard, chi2c, base))
            return (x, chi2c, conv, sp, pred, floor, badp | ~prop_ok,
                    badb | (prop_ok & ~base_ok), done, nbad)

        return iteration, proposal, chi2_fn

    def _fused_loop(self, force_f64: bool, maxiter: int,
                    required_chi2_decrease: float, max_chi2_increase: float,
                    min_lambda: float, x0):
        """The whole downhill trajectory with every decision on the
        device; the host reads ``done`` once per iteration.  An iteration
        (``_make_iteration``) is one step program
        (``CompiledModel.program``: replayed CUDA graphs on the card), the
        final covariance a proposal-only one, each rung its own.  Hazards
        (a non-finite proposal or baseline) freeze the state and set flags
        that the ladder's validator turns into refusals.  Returns (x,
        chi2, cov, conv, step_problem, pred, floor, bad_prop, bad_base,
        nbads), ``nbads`` one entry per executed iteration."""
        iteration, proposal, chi2_fn = self._make_iteration(
            force_f64, required_chi2_decrease, max_chi2_increase, min_lambda)
        shape = tuple(x0.shape)
        step = self.cm.program(iteration, (
            "downhill", force_f64, required_chi2_decrease,
            max_chi2_increase, min_lambda, shape))
        final = self.cm.program(proposal, ("downhill-proposal", force_f64,
                                           shape))
        dev = self.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=F64, device=dev)

        x = x0
        chi2c = chi2_fn(x0)
        if not bool(torch.isfinite(chi2c)):
            # a non-finite start is a caller error, never a backend
            # fault: not a trip, so no rung runs it again
            raise InvalidModelParameters(
                "initial model produces non-finite chi2")
        conv, sp, badp, badb = false, false, false, false
        pred_c, floor_c = zero, zero
        nbads = []
        for _ in range(maxiter):
            (x, chi2c, conv, sp, pred_c, floor_c, badp, badb, done,
             nbad) = step(x, chi2c, badp, badb)
            nbads.append(nbad)
            if bool(done):  # the one host read of the iteration
                break
        # covariance at the final accepted state (the loop's is one
        # Gauss-Newton step stale for x-dependent designs)
        _, cov, _, _ = final(x)
        return (x, chi2c, cov, conv, sp, pred_c, floor_c, badp, badb,
                nbads)

    def _finish_fused(self, out, maxiter: int) -> float:
        """Host tail of a fused run: the host loop's observable behaviour
        — a DegeneracyWarning per degenerate iteration, the step-problem
        and tolerance ConvergenceWarnings, ``converged``, ``niter``,
        ``last_noise_floor`` — from the loop's flags, then the commit."""
        x, chi2, cov, conv, sp, pred, floor, _badp, _badb, nbads = out
        for nb in (int(n) for n in nbads):
            if nb > 0:
                warnings.warn(
                    f"{nb} degenerate directions zeroed in downhill "
                    "proposal", DegeneracyWarning)
        self.niter = len(nbads)
        self.converged = bool(conv)
        self.last_noise_floor = float(floor)
        chi2 = float(chi2)
        if bool(sp):
            warnings.warn(
                "downhill fit: no step length decreased chi2 "
                f"(chi2={chi2:.6g}) despite a predicted "
                f"decrease of {float(pred):.3g}; keeping "
                "the best-known parameters",
                ConvergenceWarning,
            )
        elif not self.converged:
            warnings.warn(
                f"downhill fit did not meet tolerance in {maxiter} "
                "iterations",
                ConvergenceWarning,
            )
        return self._finalize(x, cov, chi2)

    def _start_x(self, x0):
        """Starting delta vector: ``cm.x0()`` (zeros, the par-file model)
        or a caller's warm start (a previous solution), copied into a
        fresh device tensor."""
        if x0 is None:
            return self.cm.x0()
        x0 = np.asarray(x0, dtype=np.float64)
        if x0.shape != (len(self.cm.free_names),):
            raise ValueError(
                f"warm-start x0 has shape {x0.shape}; expected "
                f"({len(self.cm.free_names)},)"
            )
        return torch.tensor(x0, dtype=F64, device=self.device)

    def fit_toas(
        self,
        maxiter: int = 20,
        required_chi2_decrease: float = 1e-2,
        max_chi2_increase: float = 1e-2,
        min_lambda: float = 1e-3,
        x0=None,
    ) -> float:
        """Run the fused loop down the fault ladder native -> all-f64 ->
        host loop (``runtime/fallback.py::run_ladder``, every rung on the
        fitter's device), the finite validator gating each rung.
        ``PINT_TPU_TORCH_DOWNHILL_FUSED=0`` runs the host loop outright.
        ``x0`` warm-starts the trajectory from a previous solution."""
        if os.environ.get("PINT_TPU_TORCH_DOWNHILL_FUSED", "1") == "0":
            return self._fit_toas_host(
                maxiter, required_chi2_decrease, max_chi2_increase,
                min_lambda, x0=x0,
            )
        site = f"downhill:{type(self).__name__}"
        backend = self.device.type

        def fused_thunk(force_f64):
            def thunk(_rung_site):
                return ("fused", self._fused_loop(
                    force_f64, maxiter, required_chi2_decrease,
                    max_chi2_increase, min_lambda, self._start_x(x0)))

            return thunk

        def host_thunk(_rung_site):
            return ("host", self._fit_toas_host(
                maxiter, required_chi2_decrease, max_chi2_increase,
                min_lambda, x0=x0,
            ))

        def validate(tagged, rung_site):
            kind, out = tagged
            if kind != "fused":
                return  # the host rung validates each iteration itself
            x, chi2, badp, badb = out[0], out[1], out[7], out[8]
            validate_finite({"x": x, "chi2": chi2}, site=rung_site,
                            what="fused downhill trajectory",
                            backend=backend)
            if bool(badp) or bool(badb):
                what = "proposal" if bool(badp) else "chi2 baseline"
                raise PintTpuNumericsError(
                    "fused downhill trajectory froze on a non-finite "
                    f"{what} at {rung_site}"
                )

        rungs = [
            ("native", fused_thunk(False)),
            ("f64-fallback", fused_thunk(True)),
            ("host-loop", host_thunk),
        ]
        (kind, out), report = run_ladder(rungs, site, validate=validate)
        self.guard_report = report
        if kind == "host":
            return out
        return self._finish_fused(out, maxiter)

    def _fit_toas_host(
        self,
        maxiter: int,
        required_chi2_decrease: float,
        max_chi2_increase: float,
        min_lambda: float,
        x0=None,
    ) -> float:
        """The reference's host loop: the fused loop's last ladder rung
        and the ``PINT_TPU_TORCH_DOWNHILL_FUSED=0`` escape hatch.  Sets
        ``guard_report`` itself for direct callers; the ladder overwrites
        it with the full report."""
        proposal = self._make_proposal()
        chi2_fn = self._make_chi2()
        lams, probe_lams, all_lams = _ladder_lams(min_lambda)
        # the floor comes from the probes and the lambda = 0 baseline
        # only: ladder trials up to ~8e-3 carry a true quadratic term
        # ~pred * lambda^2 that would scale the "noise" with the
        # predicted decrease far from convergence
        probe_sel = np.asarray(
            [False] * len(lams) + [True] * len(probe_lams) + [True]
        )
        ladder, _ = self._make_ladder(chi2_fn, all_lams)

        x = self._start_x(x0)
        chi2 = float(chi2_fn(x))
        if not np.isfinite(chi2):
            raise InvalidModelParameters(
                "initial model produces non-finite chi2"
            )
        self.converged = False
        self.last_noise_floor = 0.0
        self.niter = 0
        step_problem = False
        fell_back = False
        for it in range(maxiter):
            self.niter = it + 1
            dx, cov, nbad, pred, proposal, fell_back = (
                self._guarded_proposal(proposal, x, fell_back)
            )
            if int(nbad):
                warnings.warn(
                    f"{int(nbad)} degenerate directions zeroed in downhill "
                    "proposal",
                    DegeneracyWarning,
                )
            c_all = ladder(x, dx).cpu().numpy()
            c_tries = c_all[: len(lams)]
            chi2 = float(c_all[-1])  # the same-call baseline
            if not np.isfinite(chi2):
                # trials may overshoot into NaN, but a non-finite
                # baseline means the accepted state itself is poisoned
                validate_finite(
                    {"chi2_baseline": chi2},
                    site=f"downhill:{type(self).__name__}/baseline",
                    what="downhill chi2 baseline",
                    backend=self.device.type,
                )
            noise_floor = self._chi2_noise_floor(
                all_lams[probe_sel], c_all[probe_sel]
            )
            self.last_noise_floor = noise_floor
            accepted = None
            for lam, c_try in zip(lams, c_tries):
                if np.isfinite(c_try) and c_try < (
                    chi2 + max_chi2_increase + noise_floor
                ):
                    accepted = (x + lam * dx, float(c_try))
                    break
            if accepted is None:
                # No acceptable step.  The Gauss-Newton model's predicted
                # decrease decides: below the tolerance / noise floor the
                # fit had converged and the ladder's failure is noise; a
                # large predicted decrease that no trial realizes is a
                # step problem: warn, keep the best-known parameters and
                # leave converged False.
                if float(pred) > max(required_chi2_decrease, noise_floor):
                    warnings.warn(
                        "downhill fit: no step length decreased chi2 "
                        f"(chi2={chi2:.6g}) despite a predicted "
                        f"decrease of {float(pred):.3g}; keeping the "
                        "best-known parameters",
                        ConvergenceWarning,
                    )
                    step_problem = True
                else:
                    self.converged = True
                break
            x_new, chi2_new = accepted
            decrease = chi2 - chi2_new
            x, chi2 = x_new, chi2_new
            if abs(decrease) < max(required_chi2_decrease, noise_floor):
                self.converged = True
                break
        if not self.converged and not step_problem:
            warnings.warn(
                f"downhill fit did not meet tolerance in {maxiter} "
                "iterations",
                ConvergenceWarning,
            )
        # covariance at the final accepted state
        _, cov, _, _ = proposal(x)
        self.guard_report = GuardReport(
            site=f"downhill:{type(self).__name__}",
            rung="f64-fallback" if fell_back else "native",
            rung_index=1 if fell_back else 0,
        )
        return self._finalize(x, cov, float(chi2))


def _proposal_step(cm, full_cov: bool, force_f64: bool):
    """The GLS proposal step of the downhill GLS fitters: the all-f64
    Woodbury step on the fallback rung, else the dense step with
    ``full_cov``, else the mixed step on the card for a correlated-noise
    model (only the direction's quality matters, as the chi2 ladder gates
    acceptance), else the f64 step."""
    if force_f64:
        return gls_step_woodbury
    if full_cov:
        return gls_step_full_cov
    if default_accel_mode(cm) == "mixed":
        return gls_step_woodbury_mixed
    return gls_step_woodbury


class DownhillWLSFitter(DownhillFitter):
    """Downhill WLS: the proposal is ``_wls_step`` (QR on the card, SVD
    on the CPU); refuses a model with correlated noise."""

    def __init__(self, toas, model, *, device=None):
        super().__init__(toas, model, device=device)
        if self.cm.has_correlated_errors:
            raise CorrelatedErrors(model)

    def _make_proposal(self, force_f64: bool = False):
        # force_f64 changes nothing: the WLS solve is already the f64 path
        cm, noffset = self.cm, self._noffset
        method = default_wls_method(self.device)

        def proposal(x):
            r = cm.time_residuals(x, subtract_mean=False)
            M = design_with_offset(cm, x)
            w = 1.0 / torch.square(cm.scaled_sigma(x))
            dx, cov, nbad = _wls_step(r, M, w, method=method,
                                      normalized_cov=True)
            # the quadratic model's predicted chi2 decrease: dx . (-M^T W r)
            pred = -torch.dot(dx, M.T @ (w * r))
            return dx[noffset:], cov, nbad, pred

        return proposal

    def _make_chi2(self):
        # cm.chi2 profiles the offset exactly by weighted-mean subtraction
        return self.cm.chi2


class DownhillGLSFitter(DownhillFitter):
    """Downhill GLS.  The proposal is the reduced-rank Woodbury step —
    mixed on the card for a correlated-noise model (``GLSFitter``'s
    policy, whose joint Gram is the CUDA kernel), all-f64 on the CPU and
    on the fallback rung — or, with ``full_cov=True``, the dense step
    (``gls_step_full_cov``: mixed on the card, f64 on the CPU).  The
    objective is the GLS chi2 r^T C^-1 r with the implicit offset
    profiled out, chi2 - (1^T C^-1 r)^2 / (1^T C^-1 1), by Woodbury in
    every case: the dense step changes only the proposal."""

    def __init__(self, toas, model, full_cov: bool = False, *, device=None):
        super().__init__(toas, model, device=device)
        self.full_cov = full_cov

    def _noise(self, x):
        Ndiag = torch.square(self.cm.scaled_sigma(x))
        T, phi = self.cm.noise_basis_or_empty(x)
        return Ndiag, T, phi

    def _make_proposal(self, force_f64: bool = False):
        cm, noffset = self.cm, self._noffset
        step = _proposal_step(cm, self.full_cov, force_f64)

        def proposal(x):
            r = cm.time_residuals(x, subtract_mean=False)
            M = design_with_offset(cm, x)
            Ndiag, T, phi = self._noise(x)
            dx, cov, _, nbad = step(r, M, Ndiag, T, phi,
                                    normalized_cov=True)
            # the quadratic model's predicted decrease: dx . (-M^T C^-1 r)
            Cir = make_cinv_mult(Ndiag, T, phi)(r[:, None])[:, 0]
            pred = -torch.dot(dx, M.T @ Cir)
            return dx[noffset:], cov, nbad, pred

        return proposal

    def _make_chi2(self):
        cm, noffset = self.cm, self._noffset

        def chi2(x):
            r = cm.time_residuals(x, subtract_mean=False)
            Ndiag, T, phi = self._noise(x)
            cinv_mult = make_cinv_mult(Ndiag, T, phi)
            u = torch.ones_like(r)
            Cir = cinv_mult(r[:, None])[:, 0]
            c2 = torch.dot(r, Cir)
            if noffset:
                Ciu = cinv_mult(u[:, None])[:, 0]
                c2 = c2 - torch.dot(u, Cir) ** 2 / torch.dot(u, Ciu)
            return c2

        return chi2
