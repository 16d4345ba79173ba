"""Exception types of the port's fitters, fit ladder and host ingest.

Counterpart of the subset of ``pint_tpu/exceptions.py`` that the fitters
(``fitting/``), the finite validator (``runtime/guard.py``), the
fallback ladder (``runtime/fallback.py``) and the ingest layer (clock
files, ephemerides, observatories) raise, warn and catch.
"""

from __future__ import annotations


class PintTpuError(Exception):
    """Base class for the port's errors."""


class TimingModelError(PintTpuError):
    """A model cannot evaluate what was asked of it (e.g. DM residuals
    of TOAs without wideband DM measurements)."""


class ConvergenceFailure(PintTpuError):
    """A fitter failed to converge."""


class PintTpuNumericsError(ConvergenceFailure):
    """A device computation produced non-finite values (NaN/Inf).

    Raised by the finite validator (runtime/guard.py::validate_finite)
    with a ``diagnosis`` (runtime/guard.py::NumericsDiagnosis).  The one
    error that drops a rung of the fallback ladder."""

    def __init__(self, msg, diagnosis=None):
        self.diagnosis = diagnosis
        super().__init__(msg)


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
