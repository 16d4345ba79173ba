"""Exception types of the port.

Counterpart of ``pint_tpu/exceptions.py``: every class it defines, with
the same bases and constructor signatures, so that a caller's ``except
TimingModelError`` or ``except MissingParameter`` catches the same errors
from either package.  The timing-model components and the builder
(``models/``) raise ``TimingModelError``, ``MissingParameter`` and
``PrefixError`` where the reference does; the fitters (``fitting/``), the
device-execution guard (``runtime/guard.py``), fault injection
(``runtime/faults.py``), the fallback ladder (``runtime/fallback.py``),
checkpoints (``checkpoint.py``) and the ingest layer (clock files,
ephemerides, observatories) raise, warn and catch the rest.
"""

from __future__ import annotations


class PintTpuError(Exception):
    """Base class for the port's errors."""


class MissingParameter(PintTpuError):
    """A required timing-model parameter is absent or unset."""

    def __init__(self, module="", param="", msg=None):
        self.module = module
        self.param = param
        super().__init__(msg or f"{module} is missing parameter {param}")


class MissingTOAs(PintTpuError):
    """A mask parameter selects no TOAs."""

    def __init__(self, parameter_names=()):
        if isinstance(parameter_names, str):
            parameter_names = [parameter_names]
        self.parameter_names = list(parameter_names)
        super().__init__(f"Parameters {self.parameter_names} select no TOAs")


class UnknownParameter(PintTpuError):
    """Par-file line not understood by any component."""


class TimingModelError(PintTpuError):
    """An ill-formed timing model (a validation failure), or a model that
    cannot evaluate what was asked of it (e.g. DM residuals of TOAs
    without wideband DM measurements)."""


class ConvergenceFailure(PintTpuError):
    """A fitter failed to converge."""


class MaxiterReached(ConvergenceFailure):
    """Downhill fitter hit the iteration limit without meeting tolerance."""


class StepProblem(ConvergenceFailure):
    """Downhill fitter could not find a chi2-decreasing step."""


class PintTpuNumericsError(ConvergenceFailure):
    """A device computation produced non-finite values (NaN/Inf).

    Raised by the finite validator (runtime/guard.py::validate_finite)
    with a ``diagnosis`` (runtime/guard.py::NumericsDiagnosis).  The one
    error that drops a rung of the fallback ladder."""

    def __init__(self, msg, diagnosis=None):
        self.diagnosis = diagnosis
        super().__init__(msg)


class GuardTimeout(PintTpuError):
    """A guarded capture or replay exceeded its watchdog timeout
    (runtime/guard.py): a wedged kernel never returns control, so this
    is detected by the guard's host-side watchdog, not by CUDA."""

    def __init__(self, site="", timeout=None, msg=None):
        self.site = site
        self.timeout = timeout
        super().__init__(
            msg
            or f"guarded call at {site or 'unknown site'} exceeded its "
            f"{timeout}s watchdog (wedged compile/dispatch?)"
        )


class TransportRejection(PintTpuError):
    """The dispatch was rejected deterministically (the reference's HTTP
    413 class; here injected by runtime/faults.py).  Never retried with
    the same payload: the fallback ladder drops a rung instead."""


class TransientDispatchError(PintTpuError):
    """A transient dispatch failure (injected by runtime/faults.py;
    foreign errors are classified by runtime/guard.py::classify_error)."""


class RetriesExhausted(PintTpuError):
    """Bounded retries of a transient failure were exhausted."""

    def __init__(self, site="", attempts=0, last=None):
        self.site = site
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"guarded call at {site or 'unknown site'} still failing "
            f"after {attempts} attempts (last: {last!r})"
        )


class CheckpointError(PintTpuError):
    """A checkpoint file (checkpoint.py) could not be read: truncated,
    corrupt, the wrong kind, or written by a newer build.  Always raised
    typed at load time, never a bare zipfile/KeyError crash and never a
    silently partial resume."""


class LadderExhausted(ConvergenceFailure):
    """Every rung of the fallback ladder (runtime/fallback.py) was
    refused.  ``history`` records (rung_name, error) pairs in the order
    attempted."""

    def __init__(self, site="", history=()):
        self.site = site
        self.history = tuple(history)
        rungs = "; ".join(f"{n}: {e}" for n, e in self.history)
        super().__init__(
            f"fallback ladder exhausted at {site or 'unknown site'} "
            f"({len(self.history)} rungs tried: {rungs})"
        )


class GuardTripWarning(UserWarning):
    """A rung of the fallback ladder was refused and the fit was run
    again on the next rung."""


class InvalidModelParameters(PintTpuError):
    """A proposed step produced non-finite / unphysical parameters."""


class CorrelatedErrors(PintTpuError):
    """Model has correlated noise but the fitter cannot handle it."""

    def __init__(self, model):
        trouble = [c.__class__.__name__ for c in model.noise_components
                   if c.introduces_correlated_errors]
        super().__init__(
            f"Model has correlated errors ({trouble}); use a GLS fitter"
        )


class ConvergenceWarning(UserWarning):
    """A fitter stopped without meeting its convergence tolerance."""


class DegeneracyWarning(UserWarning):
    """Design matrix is degenerate; some parameters are unconstrained."""


class MissingClockCorrection(PintTpuError):
    """No clock correction available for an observatory/epoch."""


class ClockCorrectionOutOfRange(PintTpuError):
    """A TOA falls outside the span of the observatory clock file."""


class DataFileError(PintTpuError, ValueError):
    """Malformed runtime data file (EOP tables, clock files, ...)."""


class EphemerisError(PintTpuError):
    """Ephemeris file/segment problems."""


class EphemerisFormatError(EphemerisError, ValueError):
    """Malformed/unsupported SPK/DAF file (also a ValueError)."""


class EphemerisSegmentError(EphemerisError, KeyError):
    """Missing target/center segment or chain to the SSB.  Also a
    KeyError: the time ephemeris's fallback policy catches KeyError to
    retry with NAIF ids or the builtin theory."""

    # KeyError.__str__ repr-quotes the message; keep plain formatting
    __str__ = Exception.__str__


class UnknownObservatory(PintTpuError):
    """Observatory name not found in the registry."""


class PrefixError(PintTpuError):
    """Malformed prefix-parameter name."""


class RequestRejected(PintTpuError):
    """Typed load-shed rejection from the serving engine
    (``serve/engine.py``): an overloaded engine refuses work loudly and
    never hangs or silently drops a request.  ``reason`` is one of
    ``'queue-full'``, ``'deadline'``, ``'quota'`` (the request's
    composition is at its in-flight quota, ``PINT_TPU_SERVE_QUOTA``),
    ``'shutdown'`` or ``'no-replica'`` (no live replica left to take the
    batch).  The message is the reference's, string for string."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(
            f"request rejected ({reason})"
            + (f": {detail}" if detail else "")
        )


class PropertyAttributeError(PintTpuError):
    """Error raised inside a property getter (reference parity)."""
