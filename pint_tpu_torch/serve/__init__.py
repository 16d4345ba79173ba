"""pint_tpu_torch.serve — the timing-as-a-service engine.

Counterpart of ``pint_tpu/serve/``.  Four layers, each its own module:

- :mod:`pint_tpu_torch.serve.api` — typed request/response records for
  the three core operations (residuals, GLS fit, polyco phase-predict)
  with per-request deadlines and priorities;
- :mod:`pint_tpu_torch.serve.session` — the two-layer serving-state
  cache: lightweight per-par records (host parse only) and composition
  sessions keyed by (composition key, shape bucket), whose batched step
  programs every par of the composition shares;
- :mod:`pint_tpu_torch.serve.batcher` — the shape-bucketed dynamic
  micro-batcher (power-of-two TOA buckets and batch capacities: no
  program build at steady state, distinct pars stacked on the pulsar
  axis);
- :mod:`pint_tpu_torch.serve.engine` — the async pipeline (bounded
  queue, load-shedding backpressure, batches in flight on the replica
  fabric, ``serve/fabric/``).

Quick start::

    from pint_tpu_torch.serve import FitRequest, TimingEngine

    with TimingEngine() as engine:          # the CUDA card
        fut = engine.submit(FitRequest(par=par_text, toas=toas))
        response = fut.result()             # FitResponse

``TimingEngine(device="cpu", replicas=n)`` serves on the host.
``engine.open_stream(par, toas)`` opens an :class:`ObserveSession` (the
O(append) streaming surface, ``serve/stream.py``);
``engine.submit(JobRequest(kind="mcmc", ...))`` runs a preemptible
background job (``serve/jobs/``); ``TimingEngine(warm_ledger=path)``
keeps the warm surface on disk and replays it at boot
(``serve/warm_ledger.py``).
"""

from pint_tpu_torch.exceptions import RequestRejected
from pint_tpu_torch.serve.api import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AppendRequest,
    AppendResponse,
    FitRequest,
    FitResponse,
    JobRequest,
    PredictRequest,
    PredictResponse,
    Request,
    ResidualsRequest,
    ResidualsResponse,
)
from pint_tpu_torch.serve.engine import TimingEngine
from pint_tpu_torch.serve.session import SessionCache, shape_bucket
from pint_tpu_torch.serve.stream import ObserveSession

__all__ = [
    "PRIORITY_HIGH",
    "PRIORITY_LOW",
    "PRIORITY_NORMAL",
    "AppendRequest",
    "AppendResponse",
    "FitRequest",
    "FitResponse",
    "JobRequest",
    "ObserveSession",
    "PredictRequest",
    "PredictResponse",
    "Request",
    "RequestRejected",
    "ResidualsRequest",
    "ResidualsResponse",
    "SessionCache",
    "TimingEngine",
    "shape_bucket",
]
