"""pint_tpu_torch.serve.fabric — the serving fabric's one-card half.

Counterpart of ``pint_tpu/serve/fabric/``: the layer between the batcher
and the devices — per-replica queues fed by a load-aware router, not one
global dispatch loop:

- :mod:`~pint_tpu_torch.serve.fabric.replica` — a per-device executor
  that owns its device's step programs, its own stream and bounded
  inflight pipeline, and a health state machine (LIVE → DEGRADED →
  QUARANTINED → DRAINED) driven by the ``runtime/guard.py`` outcomes;
- :mod:`~pint_tpu_torch.serve.fabric.router` — session→replica placement
  with affinity (a group builds its programs once per replica it lands
  on; hot groups spill to more replicas under saturation, cold ones stay
  on one) and least-outstanding-work routing among live replicas;
- :mod:`~pint_tpu_torch.serve.fabric.pool` — device discovery (one
  replica per card; several on the CPU for the tests), the background
  canary prober that re-admits quarantined replicas, and graceful
  drain-on-shutdown.

Cross-key fusion (``Replica._fuse``, ``FusedBatch``) widens a dispatch
across the small groups queued on one replica.  The reference's gang
executors and elastic repartitioner, and the router's parts that serve
them, need several cards and are ROADMAP A12d.

Env knobs: ``PINT_TPU_SERVE_REPLICAS``, ``PINT_TPU_SERVE_AFFINITY`` (max
replicas per session group; 0 = pool width),
``PINT_TPU_SERVE_QUARANTINE_N``, ``PINT_TPU_SERVE_PROBE_MS``,
``PINT_TPU_SERVE_COALESCE``, ``PINT_TPU_SERVE_OVERLAP``,
``PINT_TPU_SERVE_XKEY_FUSE`` / ``_XKEY_THRESHOLD`` / ``_XKEY_MAX``
(cross-key fusion: on / 4096-TOA bucket cutoff / 4 members), read as the
reference reads them.
"""

from pint_tpu_torch.serve.fabric.pool import ReplicaPool, serving_devices
from pint_tpu_torch.serve.fabric.replica import (
    DEGRADED,
    DRAINED,
    LIVE,
    QUARANTINED,
    BatchWork,
    FusedBatch,
    Replica,
    health_kind,
    merge_batch_works,
)
from pint_tpu_torch.serve.fabric.router import Router

__all__ = [
    "BatchWork",
    "DEGRADED",
    "DRAINED",
    "FusedBatch",
    "LIVE",
    "QUARANTINED",
    "Replica",
    "ReplicaPool",
    "Router",
    "health_kind",
    "merge_batch_works",
    "serving_devices",
]
