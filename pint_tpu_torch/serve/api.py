"""Typed request/response records for the serving engine.

Counterpart of ``pint_tpu/serve/api.py``; the records, their fields and
their ``validate()`` messages are the reference's.  Three core
operations:

- :class:`ResidualsRequest` -> :class:`ResidualsResponse` — time
  residuals + chi2 of a par-file model against a TOA set;
- :class:`FitRequest` -> :class:`FitResponse` — an iterated GLS fit
  (equal to WLS for white-noise models) returning fitted deltas,
  uncertainties and a fitted par file;
- :class:`PredictRequest` -> :class:`PredictResponse` — polyco-backed
  absolute-phase / spin-frequency prediction at arbitrary epochs.

Every request carries a **deadline** (seconds the caller is willing to
wait; requests still queued past it are shed with a typed
:class:`~pint_tpu_torch.exceptions.RequestRejected`, never served late)
and a **priority** (lower = flushed first).  Submission is
``TimingEngine.submit(request) -> Future`` (``serve/engine.py``).

:class:`JobRequest` (a background job, ``serve/jobs/``) and
:class:`AppendRequest` (an append to a stream, made by
``serve/stream.py::ObserveSession``) complete the reference's set.

``toas`` is a port ``TOAs`` (ingested on admission when it is not yet)
or a host TOA table (``toas/bundle.py``).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import ClassVar, Optional

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError, RequestRejected  # noqa: F401
# re-exported: RequestRejected is part of the serve API surface

#: flush-ordering priorities (lower flushes first)
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


def _new_request_id() -> str:
    return uuid.uuid4().hex[:12]


@dataclass(frozen=True)
class Request:
    """Common request envelope.

    par: par-file text (str) or a TimingModel (hashed via as_parfile).
    toas: a port TOAs (ingested through toas.ingest.ingest_for_model
        when ``t_tdb`` is absent) or a host TOA table.
    deadline_s: wall-clock budget from submission; ``None`` = no
        deadline.
    priority: PRIORITY_* flush ordering.
    """

    par: object
    toas: object = None
    deadline_s: Optional[float] = None
    priority: int = PRIORITY_NORMAL
    request_id: str = field(default_factory=_new_request_id)

    op: ClassVar[str] = "?"

    def validate(self):
        if self.par is None:
            raise PintTpuError(f"{type(self).__name__} needs a par")
        if self.toas is None:
            raise PintTpuError(
                f"{type(self).__name__} needs a TOAs table"
            )
        if self.deadline_s is not None and self.deadline_s < 0:
            raise PintTpuError(
                f"negative deadline {self.deadline_s!r}"
            )


@dataclass(frozen=True)
class ResidualsRequest(Request):
    """Time residuals (s) + chi2 of the par-file model (x = 0)."""

    subtract_mean: bool = True

    op: ClassVar[str] = "residuals"


@dataclass(frozen=True)
class FitRequest(Request):
    """Iterated Gauss-Newton fit of the model's free parameters.

    method: 'auto' / 'gls' run the production GLS scan loop (equal to
        WLS when the model has no correlated noise); 'wls' asserts the
        model IS white-noise (a typed error otherwise — the serving
        engine never silently drops a correlated basis the way a
        reference WLS fit would).
    tol_chi2: convergence tolerance; None = the GLSFitter policy
        (1e-10 exact-f64, 3e-6 mixed-precision).
    """

    method: str = "auto"
    maxiter: int = 4
    tol_chi2: Optional[float] = None
    #: optional warm start: initial free-parameter deltas (nfree,).
    #: A runtime argument of the already-warmed fit kernel — a warm
    #: fit NEVER traces anything a cold fit of the same (composition,
    #: bucket) has not already traced (the streaming warm-refit path,
    #: docs/serving.md).
    x0: object = None

    op: ClassVar[str] = "fit"

    def validate(self):
        super().validate()
        if self.method not in ("auto", "gls", "wls"):
            raise PintTpuError(
                f"unknown fit method {self.method!r}: expected "
                "'auto', 'gls', or 'wls'"
            )
        if self.maxiter < 1:
            raise PintTpuError("FitRequest needs maxiter >= 1")
        if self.x0 is not None:
            x0 = np.asarray(self.x0, dtype=np.float64)
            if x0.ndim != 1:
                raise PintTpuError(
                    f"FitRequest x0 must be 1-D (got shape {x0.shape})"
                )
            if not np.all(np.isfinite(x0)):
                raise PintTpuError("FitRequest x0 must be finite")


@dataclass(frozen=True)
class PredictRequest(Request):
    """Absolute phase + spin frequency at UTC MJDs via cached polycos
    (pint_tpu_torch.polycos) — the phase-prediction operation online folders
    poll at high rate.  No TOAs: the polyco span is generated from the
    requested epochs and cached per session."""

    mjds: object = None  # (n,) UTC MJDs
    obs: str = "@"
    obsfreq_mhz: float = 1400.0
    segment_minutes: float = 60.0
    ncoeff: int = 12

    op: ClassVar[str] = "predict"

    def validate(self):
        if self.par is None:
            raise PintTpuError("PredictRequest needs a par")
        if self.mjds is None or np.size(self.mjds) == 0:
            raise PintTpuError("PredictRequest needs at least one MJD")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise PintTpuError(
                f"negative deadline {self.deadline_s!r}"
            )


@dataclass(frozen=True)
class JobRequest(Request):
    """A background-class compute job: long-running,
    preemptible, checkpointed — the second traffic class next to the
    interactive ops above.  Kinds:

    - ``grid_chisq``: the chi2 surface over the outer product of
      ``grid`` (param name -> par-file-unit values; the
      pint_tpu_torch.gridutils contract), refitting the non-gridded free
      parameters per point when ``refit``.
    - ``mcmc``: ``nsteps`` of the Goodman-Weare ensemble sampler over
      the timing posterior (pint_tpu_torch.sampler semantics; ``priors``
      override the per-parameter defaults).
    - ``nested``: nested sampling of the evidence (pint_tpu_torch.nested;
      every prior must be proper).

    Jobs run ONLY on executors the router reports idle, yield to
    interactive SLO pressure, and — when ``checkpoint_path`` is set —
    checkpoint atomically every quantum and RESUME from that file on
    resubmission (bitwise for mcmc, draw-for-draw for nested,
    cursor-exact for grids).  Admission/scheduling:
    serve/jobs/scheduler.py; docs/serving.md "background jobs"."""

    kind: str = "grid_chisq"
    #: grid_chisq: param name -> par-file-unit values (dict order =
    #: output axis order)
    grid: object = None
    refit: bool = True
    n_refit_iter: int = 2
    #: mcmc / nested
    nsteps: int = 1000
    nwalkers: int = 64
    a: float = 2.0
    seed: int = 0
    init_scale: object = 1e-8
    init_cov: object = None
    init_walkers: object = None
    priors: object = None  # param name -> models.priors Prior
    #: nested
    nlive: int = 200
    batch: int = 128
    dlogz: float = 0.1
    max_iter: int = 200000
    enlarge: float = 1.25
    method: str = "multi"
    #: resume anchor: checkpointed every quantum (atomic npz via
    #: pint_tpu_torch.checkpoint.save_job) and restored at admission when
    #: the file exists
    checkpoint_path: Optional[str] = None

    op: ClassVar[str] = "job"

    def validate(self):
        super().validate()
        if self.kind not in ("grid_chisq", "mcmc", "nested"):
            raise PintTpuError(
                f"unknown job kind {self.kind!r}: expected "
                "'grid_chisq', 'mcmc', or 'nested'"
            )
        if self.kind == "grid_chisq":
            if not isinstance(self.grid, dict) or not self.grid:
                raise PintTpuError(
                    "grid_chisq job needs a non-empty grid dict "
                    "(param name -> values)"
                )
            if self.n_refit_iter < 0:
                raise PintTpuError("n_refit_iter must be >= 0")
        if self.kind == "mcmc":
            if self.nsteps < 1:
                raise PintTpuError("mcmc job needs nsteps >= 1")
            if self.nwalkers < 2:
                raise PintTpuError("mcmc job needs nwalkers >= 2")
        if self.kind == "nested":
            if self.nlive < 2 or self.batch < 1:
                raise PintTpuError(
                    "nested job needs nlive >= 2 and batch >= 1"
                )
            if self.method not in ("multi", "single"):
                raise PintTpuError(
                    f"unknown nested method {self.method!r}"
                )


@dataclass(frozen=True)
class AppendRequest(Request):
    """Absorb a TAIL of newly-observed TOAs into a long-lived
    streaming session (serve/stream.py::ObserveSession) — the
    O(append) rank-update refit (fitting/gls.py streaming state).

    ``toas`` is the appended tail ONLY (the stream owns the absorbed
    prefix); ``state`` is the stream's host-side solver-state dict
    (Gram blocks + maintained Sigma factor + frozen basis anchor),
    threaded through the batched append kernel as runtime arguments
    and returned advanced in :class:`AppendResponse`.  Users never
    build these directly — ``ObserveSession.append`` does (it owns
    per-stream serialization and the incremental -> warm -> cold
    fallback chain)."""

    #: host-side streaming solver state (fitting/gls.py stream_state_*)
    state: object = None
    #: frozen Fourier-basis anchor: (freqs (nharm,), day0) from the
    #: stream's last refresh — appended rows evaluate the SAME basis
    freqs: object = None
    day0: float = 0.0
    #: TOAs already absorbed by the stream (response provenance only)
    ntoa_prev: int = 0

    op: ClassVar[str] = "append"

    def validate(self):
        super().validate()
        if not isinstance(self.state, dict) or "G" not in self.state:
            raise PintTpuError(
                "AppendRequest needs a streaming state dict "
                "(open a stream via TimingEngine.open_stream)"
            )


# -- responses -----------------------------------------------------------
# Every response exposes ``stages``: the request's monotonic stage
# vector — absolute time.monotonic() stamps keyed by
# pint_tpu_torch.obs.metrics.STAGES names, recorded at each pipeline
# boundary (submit/admit/close on the engine's per-request record,
# route/queue/place/dispatch/fence on the serving batch, finish at
# resolution).  Host-only ops (predict) carry only the host stages.
@dataclass
class ResidualsResponse:
    request_id: str
    ntoa: int
    residuals_s: np.ndarray  # (ntoa,) — pad rows already sliced off
    chi2: float
    bucket: int  # TOA-axis shape bucket that served the request
    batch_size: int  # live requests stacked in the serving batch
    wall_ms: float  # submit -> result wall time
    replica: str = ""  # fabric executor tag ('r3', or 'g0' for a gang)
    stages: dict = field(default_factory=dict)  # monotonic stage stamps


@dataclass
class FitResponse:
    request_id: str
    names: tuple  # free-parameter names, delta/uncertainty order
    deltas: np.ndarray  # fitted deltas, internal units
    uncertainties: np.ndarray  # 1-sigma, internal units
    chi2: float
    converged: bool
    method: str  # effective method actually run ('gls')
    mode: str  # accelerator step mode ('mixed' | 'f64')
    fitted_par: str  # par-file text with fitted values committed
    ntoa: int
    bucket: int
    batch_size: int
    wall_ms: float
    replica: str = ""  # fabric executor tag ('rN' single, 'gN' gang)
    stages: dict = field(default_factory=dict)  # monotonic stage stamps


@dataclass
class AppendResponse:
    """Result of one absorbed tail.  ``refit`` records which rung of
    the streaming fallback chain actually served it: 'incremental'
    (the O(append) rank-update kernel), 'warm' (a full refit warm
    -started from the stream's solution — same warmed fit kernel,
    zero retraces), or 'cold' (a from-scratch fit; the drift guard's
    last rung)."""

    request_id: str
    ntoa: int  # TOTAL TOAs absorbed by the stream after this append
    appended: int  # live tail rows in this request
    names: tuple
    deltas: np.ndarray  # updated free-parameter deltas (nfree,)
    uncertainties: np.ndarray
    chi2: float
    converged: bool
    refit: str  # 'incremental' | 'warm' | 'cold'
    alerts: tuple  # residual-anomaly alert strings ('' = none)
    bucket: int  # TAIL-axis shape bucket that served the append
    batch_size: int
    wall_ms: float
    replica: str = ""
    stages: dict = field(default_factory=dict)  # monotonic stage stamps
    #: advanced solver state (engine-internal; ObserveSession commits
    #: it and strips it before handing the response to the caller)
    state: object = None


@dataclass
class JobResponse:
    """Result of one background job.  ``result`` is the kind-specific
    payload: grid_chisq -> {chi2 (grid-shaped), names, shape, npts};
    mcmc -> {chain (nsteps, nwalkers, ndim), lnp, acceptance};
    nested -> the pint_tpu_torch.nested result dict (logz, samples, ...).
    ``quanta``/``preemptions``/``resumed`` are the job's flight
    provenance (how many device-time slices it took, how often it
    yielded to interactive pressure, whether it continued from an
    on-disk checkpoint)."""

    request_id: str
    kind: str
    result: dict
    quanta: int
    preemptions: int
    resumed: bool
    ntoa: int
    bucket: int
    wall_ms: float
    stages: dict = field(default_factory=dict)  # monotonic stage stamps


@dataclass
class PredictResponse:
    request_id: str
    phase_int: np.ndarray  # integer cycles at each MJD
    phase_frac: np.ndarray  # fractional cycles
    spin_freq_hz: np.ndarray
    cached: bool  # True when the polyco span was already generated
    wall_ms: float
    stages: dict = field(default_factory=dict)  # monotonic stage stamps
