"""The fit's fallback ladder: the native mode, then all-f64, on one device.

Counterpart of ``pint_tpu/runtime/fallback.py`` (:class:`GuardReport`,
:func:`run_ladder`, :func:`fit_rungs`, :func:`run_fit_ladder`).  A fit
runs on its native rung (``f"{device.type}-{mode}"``, e.g.
``cuda-fourier``); when the finite validator refuses the result, the
same fit runs again on the all-f64 rung of the same device
(``cuda-f64``), and the report records which rung served and what was
refused on the way down.

There is **no CPU rung**.  The reference ends its ladder with a
re-dispatch of the f64 fit to the host; here a fit that was asked of the
card either runs on the card or raises :class:`LadderExhausted`, so a
host run can never stand in for a card run.

Only :class:`PintTpuNumericsError` drops a rung (the reference's other
trip errors are its TPU transport's).  Anything else — a failed kernel
launch, a shape error — propagates at once: running the fit again on
another rung cannot fix a wrong program.
"""

from __future__ import annotations

import dataclasses
import warnings

from pint_tpu_torch.exceptions import (
    GuardTripWarning,
    LadderExhausted,
    PintTpuNumericsError,
)
from pint_tpu_torch.runtime.guard import ensure_scan_finite

#: the errors that drop a rung
TRIP_ERRORS = (PintTpuNumericsError,)


@dataclasses.dataclass(frozen=True)
class GuardReport:
    """Which rung served a laddered computation, and what tripped on
    the way down.  ``history`` is ((rung_name, 'ExcType: msg'), ...)
    for the rungs that failed before ``rung`` succeeded."""

    site: str
    rung: str
    rung_index: int
    history: tuple = ()

    @property
    def fell_back(self) -> bool:
        return self.rung_index > 0

    def to_dict(self) -> dict:
        return {
            "site": self.site,
            "rung": self.rung,
            "rung_index": self.rung_index,
            "history": [list(h) for h in self.history],
        }


def run_ladder(rungs, site: str, validate):
    """Try ``rungs`` = [(name, thunk), ...] in order.

    ``thunk(rung_site)`` runs the computation; ``validate(result,
    rung_site)`` raises PintTpuNumericsError to refuse a rung's result.
    Returns (result, GuardReport).  Raises LadderExhausted when every
    rung trips."""
    history = []
    for i, (name, thunk) in enumerate(rungs):
        rung_site = f"{site}/rung:{name}"
        try:
            out = thunk(rung_site)
            validate(out, rung_site)
            return out, GuardReport(
                site=site, rung=name, rung_index=i, history=tuple(history),
            )
        except TRIP_ERRORS as e:
            history.append((name, f"{type(e).__name__}: {e}"))
            if i + 1 < len(rungs):
                warnings.warn(
                    f"guard tripped on rung {name!r} at {site} "
                    f"({type(e).__name__}); falling back to rung "
                    f"{rungs[i + 1][0]!r}",
                    GuardTripWarning,
                )
    raise LadderExhausted(site, history)


def fit_rungs(mode: str, device_type: str, f64_rung: bool = True):
    """The rung sequence [(name, rung_mode), ...] for a fit of the given
    native mode on a device of ``device_type``: the native mode, then
    the all-f64 mode unless the native mode is f64.  ``f64_rung=False``
    skips the all-f64 rung (WLS: its one solve method is already the f64
    path), leaving one rung.  No CPU rung."""
    seq = [(f"{device_type}-{mode}", mode)]
    if f64_rung and mode != "f64":
        seq.append((f"{device_type}-f64", "f64"))
    return seq


def run_fit_ladder(cm, mode: str, run_loop, site: str, fail_msg: str,
                   f64_rung: bool = True):
    """Run a fit loop down the ladder.  ``run_loop(rung_mode)`` runs the
    whole fit (``fitting/base.py::run_fit_loop``) in that mode from
    ``cm.x0()``; each rung's result is refused by
    :func:`~pint_tpu_torch.runtime.guard.ensure_scan_finite` when it
    froze on a non-finite chi2 or ends in a non-finite state."""

    def thunk(rung_mode):
        return lambda rung_site: run_loop(rung_mode)

    rungs = [(name, thunk(rmode))
             for name, rmode in fit_rungs(mode, cm.device.type, f64_rung)]
    return run_ladder(
        rungs, site,
        validate=lambda res, s: ensure_scan_finite(res, fail_msg, s),
    )
