"""The scheduler-side job record.

Counterpart of ``pint_tpu/serve/jobs/api.py``.  One :class:`Job` per
admitted :class:`~pint_tpu_torch.serve.api.JobRequest`: the resolved
session and record, the padded single-par operands (the bundle and
reference vectors every quantum rides in on), the runner (kind-specific
progress, ``serve/jobs/runner.py``), and the lifecycle bookkeeping the
scheduler and ``stats()`` read (state, quanta, preemptions, the sticky
home replica, stage stamps).

States: ``QUEUED`` (admitted, waiting for idle capacity) -> ``RUNNING``
(quanta dispatching) <-> ``PREEMPTED`` (yielded to interactive pressure;
checkpointed) -> resolved (future done).
"""

from __future__ import annotations

import time

QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"


class Job:
    """One background job in flight (owned by the scheduler thread after
    admission; ``future`` and ``stages`` follow the engine's request
    conventions, so responses carry the same monotonic stage vector
    interactive requests do)."""

    def __init__(self, req, future, t_submit=None):
        self.req = req
        self.future = future
        self.t_submit = time.monotonic() if t_submit is None else t_submit
        self.stages = {"submit": self.t_submit}
        self.flow = req.request_id
        self.state = QUEUED
        # admission fills these (scheduler._admit)
        self.session = None
        self.record = None
        self.bundle = None  # padded single-par bundle (host numpy)
        self.refnum = None  # (refvec, flatvec)
        self.runner = None
        self.priors = None
        self.prior_tag = ""
        self.ledgerable = False
        # progress and lifecycle bookkeeping
        self.quanta = 0
        self.preemptions = 0
        self.resumed = False  # restored from an on-disk checkpoint
        self.fault_count = 0
        self.excluded: set = set()  # replica tags that failed a quantum
        self.home = None  # sticky replica tag (its programs are built)
        self.checkpoint_payload = None  # last in-memory checkpoint

    @property
    def kind(self) -> str:
        return self.req.kind
