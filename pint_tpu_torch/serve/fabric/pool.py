"""Replica pool: device discovery, the canary prober, graceful drain.

Counterpart of ``pint_tpu/serve/fabric/pool.py``.  The pool turns the
serving devices (:func:`serving_devices`, the counterpart of the
reference's ``parallel/mesh.py::serving_devices``) into one
:class:`~pint_tpu_torch.serve.fabric.replica.Replica` each, runs the
background probe loop that re-admits quarantined replicas once their
canary launch answers sanely, and owns the drain-on-shutdown contract:
in-flight batches fence, queued requests complete or shed as typed
``RequestRejected(reason='shutdown')`` — never hang.  The engine hands
the pool its warm-ledger replay hook (``replayer``); online repartition
(``repartition``, the reference's elastic fabric, the hook's consumer
there) is ROADMAP A12d.

Env knobs (constructor kwargs override):

- ``PINT_TPU_SERVE_REPLICAS`` — pool width (0/unset: one replica per
  visible card; on the CPU, one);
- ``PINT_TPU_SERVE_QUARANTINE_N`` — consecutive guard-class failures
  before a replica quarantines (default 3);
- ``PINT_TPU_SERVE_PROBE_MS`` — canary probe cadence for unhealthy
  replicas (default 500 ms).
"""

from __future__ import annotations

import os
import threading

import torch

from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import lockwitness
from pint_tpu_torch.serve.fabric.replica import (
    DEGRADED,
    LIVE,
    QUARANTINED,
    Replica,
)


def serving_devices(device, n: int | None = None) -> list:
    """The devices the pool's replicas serve on, one entry a replica.

    On the card (``device`` of type ``cuda`` without an index): one
    replica per visible card by default; ``n`` replicas are spread over
    the cards in turn, so ``n`` above the card count puts several
    replicas on one card (each with its own stream and programs).  A
    ``cuda:i`` device pins them all to card i.  On the CPU ``n``
    replicas (default 1) share the host: the stand-in for the
    reference's virtual 8-device mesh in the tests."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * max(1, int(n or 1))
    if device.index is not None:
        return [device] * max(1, int(n or 1))
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    n = len(cards) if not n else int(n)
    return [cards[i % len(cards)] for i in range(max(1, n))]


class ReplicaPool:
    """One replica per serving device + the canary prober thread."""

    def __init__(self, *, device, replicas: int | None = None,
                 inflight: int, quarantine_n: int | None = None,
                 probe_interval_s: float | None = None,
                 requeue=None, finisher=None, validator=None,
                 replayer=None):
        env = os.environ.get
        if replicas is None:
            replicas = int(env("PINT_TPU_SERVE_REPLICAS", "0"))
        if quarantine_n is None:
            quarantine_n = int(env("PINT_TPU_SERVE_QUARANTINE_N", "3"))
        if probe_interval_s is None:
            probe_interval_s = (
                float(env("PINT_TPU_SERVE_PROBE_MS", "500")) / 1e3
            )
        self.probe_interval_s = max(0.01, float(probe_interval_s))
        # the warm ledger's job source (the engine's replay closure):
        # prewarm work for replicas that join after the boot
        self._replayer = replayer
        self.replicas = [
            Replica(rid, d, tag=f"r{rid}", inflight=inflight,
                    quarantine_n=quarantine_n, requeue=requeue,
                    finisher=finisher, validator=validator)
            for rid, d in enumerate(serving_devices(device, replicas))
        ]
        self._cond = lockwitness.wrap(
            threading.Condition(), "ReplicaPool._cond"
        )
        self._stop = False
        self._prober = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="pint-tpu-fabric prober",
        )
        self._prober.start()

    @property
    def size(self) -> int:
        return len(self.replicas)

    @property
    def live(self) -> list:
        """Replicas currently accepting routed work."""
        return [
            r for r in self.replicas
            if r.state in (LIVE, DEGRADED) and not r.draining
        ]

    def replica(self, rid: int) -> Replica:
        """Lookup by rid."""
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no executor with rid {rid} in the pool")

    # -- the canary prober -------------------------------------------------
    def _probe_loop(self):
        """Every ``probe_interval_s``, canary-launch each unhealthy
        replica (the canary runs the guarded chokepoints with the
        replica-tagged site, so the fault that tripped it keeps failing
        until it actually clears):

        - QUARANTINED + passing canary -> re-admitted;
        - DEGRADED replicas are probed too, and the canary outcome counts
          as a success/failure toward the health machine, so a degraded
          replica the router avoids still converges to LIVE or
          QUARANTINED instead of parking in DEGRADED."""
        TRACER.name_thread("fabric prober")
        while True:
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(self.probe_interval_s)
                if self._stop:
                    return
            for r in self.replicas:
                if r.draining:
                    continue
                state = r.state
                if state == QUARANTINED:
                    if r.probe():
                        r.readmit()
                        TRACER.event(
                            "readmit", "fabric", replica=r.tag
                        )
                elif state == DEGRADED:
                    if r.probe():
                        r.note_success()
                    else:
                        r.note_failure("probe")

    # -- pre-warm ------------------------------------------------------------
    def prewarm(self, works: list, replicas: list | None = None) -> int:
        """Warm each of ``works`` (assembled BatchWorks) on every replica
        of ``replicas`` (default: the pool) before traffic arrives:
        programs built and, on the card, captured.  Must run before the
        engine routes work to these replicas
        (``Replica.prewarm_kernel``).  Per-(work, replica) failures are
        counted (``serve.warm.failed``) and skipped: a bad entry costs
        warmth, never a boot."""
        targets = list(self.replicas) if replicas is None else replicas
        warmed = 0
        for work in works:
            for r in targets:
                with TRACER.span(
                    "pool:prewarm", "fabric", replica=r.tag,
                    op=work.key[0], cap=work.cap,
                    bucket=work.session.bucket,
                ):
                    try:
                        r.prewarm_kernel(work)
                        warmed += 1
                        obs_metrics.counter("serve.warm.replayed").inc()
                    except Exception as e:
                        obs_metrics.counter("serve.warm.failed").inc()
                        TRACER.event(
                            "prewarm-failed", "fabric", replica=r.tag,
                            op=work.key[0], error=repr(e),
                        )
        return warmed

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        return {
            r.tag: {
                "state": r.state,
                "outstanding": r.outstanding,
                "batches": r.batches_done,
                "failures": r.failures,
                "kernels": r.kernel_count,
                "device": str(r.device),
            }
            for r in self.replicas
        }

    def drain(self, timeout: float = 120.0):
        """Stop the prober, then drain every replica (queued work
        completes or sheds typed; threads join)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._prober.join(5.0)
        for r in self.replicas:
            r.drain(timeout)
