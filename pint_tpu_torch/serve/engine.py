"""TimingEngine: the async request-serving pipeline.

Counterpart of ``pint_tpu/serve/engine.py``.  Every device call routes
through the guarded dispatch chokepoint (a replica's
``runtime/graphs.py::ProgramCache`` -> ``runtime/guard.py``), every stage
is span/metric-instrumented (``pint_tpu_torch.obs``), and serving state
is cached at two levels (session LRU -> each replica's step programs,
captured once on the card).

Pipeline:

1. **submit** (caller thread): bounded admission queue.  A full queue
   rejects IMMEDIATELY with a typed RequestRejected('queue-full') —
   load shedding by refusal, never by OOM or hang.
2. **collector** (one thread): drains the queue, resolves sessions
   (``serve/session.py``), pads/buckets each request, accumulates
   micro-batches (``serve/batcher.py``), and flushes full or overdue
   groups: shed expired deadlines, stack operands on the host, then
   ROUTE the assembled batch onto a replica (``serve/fabric/router.py``
   affinity placement + least-outstanding-work among live replicas).
3. **replicas** (``serve/fabric/replica.py`` — each with a dispatcher and
   a fencer thread and its own bounded inflight pipeline): operands to
   the device, the guarded batched programs launched, the fence keeps
   the batch's watchdog deadlines and reads the results, batch-level
   finite validation, then futures resolve through the engine's
   serialized finisher.  A replica whose guard trips (watchdog/NaN)
   degrades and eventually quarantines; its work re-routes to surviving
   replicas and the pool's canary probe re-admits it.

Backpressure: each replica caps queued+inflight batches; when the routed
replica's queue is full the collector blocks, the admission queue fills,
and new submissions shed — typed rejections at the edge.

Sessions are composition-keyed: the collector resolves each request into
a lightweight per-par record (host parse) plus a shared composition
session, so requests with DIFFERENT pars of one composition stack into
one batched dispatch — N distinct-par clients cost one program build per
(bucket, batch capacity) and replica, total.

Fleet operability: the batcher closes a group EARLY when its oldest
member's deadline is within ``PINT_TPU_SERVE_SLO_CLOSE`` ms
(``serve.slo.early_close``), replicas re-check deadlines at the dispatch
boundary so expired work never burns a launch (``serve.shed.late``), and
a per-composition in-flight quota (``PINT_TPU_SERVE_QUOTA``) sheds typed
``RequestRejected('quota')``.

``device`` (keyword-only) is where the engine serves: None means the CUDA
card (one replica per visible card) and raises without one, like every
entry point of the port; ``device="cpu"`` serves on the host with
``replicas`` replicas (the tests' stand-in for the reference's virtual
8-device mesh).  Knobs with ``PINT_TPU_SERVE_*`` env defaults, as the
reference reads them: MAX_QUEUE, MAX_BATCH, MAX_WAIT_MS, INFLIGHT,
SESSIONS, PARS, MIN_BUCKET, REPLICAS, AFFINITY, QUARANTINE_N, PROBE_MS,
QUOTA, SLO_CLOSE, COALESCE, OVERLAP, XKEY_FUSE, XKEY_THRESHOLD,
XKEY_MAX, STREAMS, WARM_LEDGER (and the job scheduler's JOBS_*).

The fleet's one-card half:

- **streams** — ``open_stream`` returns an
  :class:`~pint_tpu_torch.serve.stream.ObserveSession` whose appends are
  ``AppendRequest`` batches on the fabric (the O(append) program), its
  continuations on the engine's stream executor, off the fence threads;
  at most ``PINT_TPU_SERVE_STREAMS`` are open;
- **background jobs** — a ``JobRequest`` bypasses the interactive queue
  into the preemptible :class:`~pint_tpu_torch.serve.jobs.JobScheduler`;
- **warm restarts** — with ``warm_ledger=`` (or
  ``PINT_TPU_SERVE_WARM_LEDGER``) every program the fabric builds is
  recorded (``serve/warm_ledger.py``), and a restarted engine REPLAYS the
  ledger before its collector starts: sessions rebuild from their
  sidecars and every ledgered (key, capacity) is built and captured, so
  the same traffic afterwards builds and captures nothing.

Gang executors (``gangs=``, ``gang_size=``, ``gang_threshold=``) and the
elastic repartitioner (``elastic=``) need several cards and come with
ROADMAP A12d; they are refused.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import Future

import numpy as np

from pint_tpu_torch.device import resolve_device
from pint_tpu_torch.exceptions import PintTpuError, RequestRejected
from pint_tpu_torch.fitting.base import noffset
from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import lockwitness
from pint_tpu_torch.runtime.graphs import ProgramCache
from pint_tpu_torch.runtime.guard import validate_finite
from pint_tpu_torch.serve import batcher as bmod
from pint_tpu_torch.serve import session as smod
from pint_tpu_torch.serve.fabric import BatchWork, ReplicaPool, Router


def _not_ported(what: str) -> PintTpuError:
    return PintTpuError(
        f"{what} is not ported to pint_tpu_torch yet (ROADMAP A12d)"
    )


class _Pending:
    """One admitted request flowing through the pipeline."""

    __slots__ = ("req", "future", "t_submit", "session", "record",
                 "bundle", "ntoa", "stages")

    def __init__(self, req, future, t_submit):
        self.req = req
        self.future = future
        self.t_submit = t_submit
        self.session = None  # composition Session (compiled layer)
        self.record = None  # per-par ParRecord (lightweight layer)
        self.bundle = None  # padded host-numpy TOABundle
        self.ntoa = None  # the request's own TOA count
        # per-request stage clock: monotonic stamps keyed by
        # obs.metrics.STAGES names.  Host stages (submit/admit/close)
        # live here; batch stages ride BatchWork.stamps and the two merge
        # at finish.  Exactly one thread owns the record at each
        # boundary, so no lock.
        self.stages = {"submit": t_submit}


class TimingEngine:
    """Session-cached, shape-bucketed, async timing service."""

    def __init__(self, *, device=None, max_queue=None, max_batch=None,
                 max_wait_ms=None, inflight=None, min_bucket=None,
                 max_sessions=None, replicas=None, affinity=None,
                 quarantine_n=None, probe_ms=None, gangs=None,
                 gang_size=None, gang_threshold=None, quota=None,
                 slo_close_ms=None, warm_ledger=None, prewarm=True,
                 elastic=None):
        from pint_tpu_torch.serve import warm_ledger as wlmod
        from pint_tpu_torch.serve.jobs import JobScheduler

        if gangs or gang_size or gang_threshold is not None:
            raise _not_ported(
                "gang executors (gangs=, gang_size=, gang_threshold=)")
        if elastic:
            raise _not_ported("the elastic repartitioner (elastic=)")
        self.device = resolve_device(device)
        env = os.environ.get
        self.max_queue = int(
            max_queue if max_queue is not None
            else env("PINT_TPU_SERVE_MAX_QUEUE", "256")
        )
        self.max_batch = int(
            max_batch if max_batch is not None
            else env("PINT_TPU_SERVE_MAX_BATCH", "16")
        )
        wait_ms = float(
            max_wait_ms if max_wait_ms is not None
            else env("PINT_TPU_SERVE_MAX_WAIT_MS", "5.0")
        )
        self.max_wait_s = wait_ms / 1e3
        self.inflight = int(
            inflight if inflight is not None
            else env("PINT_TPU_SERVE_INFLIGHT", "4")
        )
        self.min_bucket = min_bucket
        # streaming sessions: a bounded count of long-lived
        # ObserveSessions; past the cap open_stream sheds typed
        self.max_streams = int(env("PINT_TPU_SERVE_STREAMS", "64"))
        self._streams: set = set()
        self._streams_lock = lockwitness.wrap(
            threading.Lock(), "TimingEngine._streams_lock"
        )
        # the stream continuation executor (lazy): commit and fallback
        # work runs OFF the replica fence threads
        self._stream_exec = None
        # the streams' state-init programs, per (composition, bucket)
        self._stream_programs = ProgramCache(self.device)
        self._stream_kernels: dict = {}
        # per-composition in-flight admission quota: 0/unset = unlimited
        self.quota = int(
            quota if quota is not None
            else env("PINT_TPU_SERVE_QUOTA", "0")
        )
        # SLO-aware early-close margin (ms; 0 disables): how far ahead of
        # a member's deadline its group closes
        slo_ms = float(
            slo_close_ms if slo_close_ms is not None
            else env("PINT_TPU_SERVE_SLO_CLOSE", "25")
        )
        self.slo_margin_s = None if slo_ms <= 0 else slo_ms / 1e3
        self.sessions = smod.SessionCache(max_sessions, device=self.device)
        self._queue: collections.deque = collections.deque()
        self._cond = lockwitness.wrap(
            threading.Condition(), "TimingEngine._cond"
        )
        self._batcher = bmod.Batcher(
            self.max_batch, self.max_wait_s,
            slo_margin_s=self.slo_margin_s,
        )
        self._quota_lock = lockwitness.wrap(
            threading.Lock(), "TimingEngine._quota_lock"
        )
        self._quota_inflight: dict = {}  # cid -> admitted unresolved
        self._stop = False
        # host response assembly (par text, model clones) is serialized
        # across replica fence threads
        self._finish_lock = lockwitness.wrap(
            threading.Lock(), "TimingEngine._finish_lock"
        )
        # the warm-restart ledger: made BEFORE the pool, whose replay
        # hook resolves works from it
        self._ledger = None
        path = wlmod.ledger_path(warm_ledger)
        if path is not None:
            self._ledger = wlmod.WarmLedger(path)
            wlmod.register(self._ledger)
        self.pool = ReplicaPool(
            device=self.device,
            replayer=self._replay_jobs,
            replicas=replicas,
            inflight=max(1, self.inflight),
            quarantine_n=quarantine_n,
            probe_interval_s=(
                None if probe_ms is None else float(probe_ms) / 1e3
            ),
            requeue=self._requeue,
            finisher=self._finish_batch,
            validator=self._validate_batch,
        )
        if affinity is None:
            affinity = int(env("PINT_TPU_SERVE_AFFINITY", "0"))
        self.router = Router(self.pool, affinity=affinity or None)
        m = obs_metrics
        self._m_requests = m.counter("serve.requests")
        self._m_completed = m.counter("serve.completed")
        self._m_shed = m.counter("serve.shed")
        self._m_rejected = m.counter("serve.rejected")
        self._m_batches = m.counter("serve.batches")
        self._m_occupancy = m.histogram("serve.batch_occupancy")
        # stack occupancy: DISTINCT pars per batch
        self._m_stack_pars = m.histogram("serve.stack.distinct_pars")
        self._m_latency = m.histogram("serve.latency_ms", unit="ms")
        # per-stage latency attribution: sliding-window histograms, the
        # total plus one per pipeline stage (dwell = consecutive-stamp
        # delta), and the worst-k slow-request exemplar reservoir
        self._m_lat_total = m.window_histogram(
            "serve.latency.total", unit="ms"
        )
        self._m_lat_stage = {
            s: m.window_histogram(f"serve.latency.stage.{s}", unit="ms")
            for s in obs_metrics.STAGES[1:]
        }
        self._m_exemplars = m.exemplars("serve.latency.exemplars")
        self._m_depth = m.gauge("serve.queue_depth")
        self._m_quota = m.counter("serve.quota_rejected")
        self._m_slo_close = m.counter("serve.slo.early_close")
        # the background compute class: built before the warm replay so
        # ledgered job programs prewarm through the scheduler's own cache
        self._jobs = JobScheduler(self)
        # the warm ledger's boot REPLAY, before the collector exists (the
        # replicas have been routed no work yet: prewarm_kernel's
        # contract)
        self.replay_s = None
        if self._ledger is not None and prewarm:
            t0 = time.perf_counter()
            with TRACER.span("serve:warm-replay", "serve", path=path):
                works = self._replay_jobs(include_jobs=True)
                interactive = [w for w, _ in works if w.key[0] != "job"]
                background = [wp for wp in works if wp[0].key[0] == "job"]
                if interactive:
                    self.pool.prewarm(interactive)
                if background:
                    self._jobs.prewarm(background)
            self.replay_s = time.perf_counter() - t0
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="pint-tpu-serve collector",
        )
        self._collector.start()

    # -- the request-facing edge ------------------------------------------
    def submit(self, request) -> Future:
        """Enqueue one request; returns a Future resolving to the
        op-matched response record (``serve/api.py``) or raising the
        typed failure (RequestRejected on shed/rejection, a diagnosed
        PintTpuNumericsError on non-finite device results, guard errors
        on exhausted dispatch supervision)."""
        fut: Future = Future()
        self._m_requests.inc()
        with TRACER.span(
            "serve:submit", "serve", op=request.op,
            request_id=request.request_id, flow=request.request_id,
        ):
            if request.op == "job":
                # background compute class: jobs bypass the interactive
                # queue and batcher into the preemptible JobScheduler
                return self._jobs.submit(request, fut)
            with self._cond:
                if self._stop:
                    fut.set_exception(RequestRejected(
                        "shutdown", "engine is closed"
                    ))
                    return fut
                if len(self._queue) >= self.max_queue:
                    self._m_rejected.inc()
                    TRACER.event(
                        "shed", "serve", reason="queue-full",
                        op=request.op,
                    )
                    obs_metrics.note_shed_stage(
                        "queue-full", {"submit": time.monotonic()}
                    )
                    fut.set_exception(RequestRejected(
                        "queue-full",
                        f"{len(self._queue)} queued >= "
                        f"max_queue={self.max_queue}",
                    ))
                    return fut
                self._queue.append(
                    _Pending(request, fut, time.monotonic())
                )
                self._m_depth.set(len(self._queue))
                self._cond.notify()
        return fut

    def submit_many(self, requests) -> list:
        return [self.submit(r) for r in requests]

    def open_stream(self, par, toas, **kwargs):
        """Open a long-lived streaming session: a cold fit and a solver
        state build over ``toas``, returning an
        :class:`~pint_tpu_torch.serve.stream.ObserveSession` whose
        ``append(tail)`` absorbs newly observed TOAs at O(append) cost
        through the replica fabric.  Blocking (the cold fit is O(n));
        bounded by ``PINT_TPU_SERVE_STREAMS`` — past the cap it sheds
        typed ``RequestRejected('streams')``."""
        from pint_tpu_torch.serve.stream import ObserveSession

        with self._streams_lock:
            if len(self._streams) >= self.max_streams:
                self._m_rejected.inc()
                TRACER.event(
                    "shed", "serve", reason="streams",
                    open=len(self._streams),
                )
                raise RequestRejected(
                    "streams",
                    f"{len(self._streams)} streams open >= "
                    f"PINT_TPU_SERVE_STREAMS={self.max_streams}",
                )
        s = ObserveSession(self, par, toas, **kwargs)
        with self._streams_lock:
            self._streams.add(s)
            n = len(self._streams)
        obs_metrics.gauge("serve.streams.open").set(n)
        return s

    def _close_stream(self, s):
        with self._streams_lock:
            self._streams.discard(s)
            n = len(self._streams)
        obs_metrics.gauge("serve.streams.open").set(n)

    def _stream_executor(self):
        """The lazily made executor of stream continuations (commit and
        fallback work), OFF the replica fence threads, where they would
        run inside the serialized finisher and stall co-batched
        members."""
        from concurrent.futures import ThreadPoolExecutor

        with self._streams_lock:
            if self._stream_exec is None:
                self._stream_exec = ThreadPoolExecutor(
                    max_workers=2,
                    thread_name_prefix="pint-tpu-stream",
                )
            return self._stream_exec

    def _stream_init(self, sess, ops):
        """Run a stream's state-init program (``serve/session.py::
        build_stream_init_kernel``) for ``sess`` on ``ops``, built once
        per (composition, bucket) in the engine's stream program cache;
        -> the state as host numpy."""
        key = ("stream-init", sess.composition, sess.bucket)
        k = self._stream_kernels.get(key)
        if k is None:
            inner = smod.build_stream_init_kernel(
                sess, ops, self._stream_programs, key,
                f"serve:stream-init:b{sess.bucket}",
            )
            k = self._stream_kernels[key] = smod.serialized(
                inner, sess.trace_lock, self.device.type == "cuda")

        def launch():
            import torch

            leaves = [torch.as_tensor(np.ascontiguousarray(a),
                                      device=self.device)
                      for a in bmod.tree_leaves(ops)]
            return k(*leaves)

        return smod.run_fenced(launch, self.device)

    # -- stage 2: collector ------------------------------------------------
    def _collect_loop(self):
        TRACER.name_thread("serve-collector")
        while True:
            with self._cond:
                if not self._queue and not self._stop:
                    self._cond.wait(
                        self._batcher.next_wait_s(time.monotonic())
                    )
                drained = list(self._queue)
                self._queue.clear()
                self._m_depth.set(0)
                stopping = self._stop
            ready = []
            for p in drained:
                full = self._admit(p)
                if full is not None:
                    ready.append(full)
            # a slow admit (cold session build) lets co-wave requests pile
            # up in the admission queue past their group's max-wait; drain
            # them into their groups before expiring partial ones, or one
            # slow build splits a wave into fragment batches
            with self._cond:
                draining_more = bool(self._queue) and not stopping
            if not draining_more:
                ready += self._batcher.take_due(
                    time.monotonic(), take_all=stopping
                )
            for batch in sorted(ready, key=lambda b: b.priority):
                self._flush(batch)
            if stopping:
                with self._cond:
                    if not self._queue and self._batcher.empty():
                        break

    def _admit(self, p: _Pending):
        """Resolve session + bucket for one drained request; returns a
        full group ready to flush, or None.  Stamps the request's
        ``admit`` stage and opens the collector-thread node of its flow
        arc."""
        req = p.req
        p.stages["admit"] = time.monotonic()
        try:
            req.validate()
            if req.op == "predict":
                with TRACER.span(
                    "serve:admit", "serve", op=req.op,
                    flow=req.request_id,
                ):
                    self._predict(p)
                return None
            rec, sess, padded, ntoa = self._session_for_request(req)
            p.session = sess
            p.record = rec
            p.ntoa = ntoa
            self._check_quota(p, sess.cid)
            if req.op == "fit":
                if req.method == "wls" and sess.cm.has_correlated_errors:
                    raise PintTpuError(
                        "FitRequest(method='wls') on a model with "
                        "correlated noise — use 'gls'/'auto' (the "
                        "serving engine refuses to silently drop the "
                        "noise basis)"
                    )
                tol = req.tol_chi2
                if tol is None:
                    tol = 1e-10 if sess.mode == "f64" else 3e-6
                if req.x0 is not None \
                        and np.size(req.x0) != sess.cm.nfree:
                    raise PintTpuError(
                        f"FitRequest x0 has {np.size(req.x0)} entries; "
                        f"the model has {sess.cm.nfree} free parameters"
                    )
                key = (
                    "fit", sess.composition, sess.bucket, sess.mode,
                    int(req.maxiter), float(tol),
                )
            elif req.op == "residuals":
                key = (
                    "residuals", sess.composition, sess.bucket,
                    bool(req.subtract_mean),
                )
            elif req.op == "append":
                # O(append) streaming: the session and bucket are the
                # TAIL's — the absorbed prefix lives in the request's
                # solver state, so appending to a 1e6-TOA stream batches
                # through the same small-bucket program as any other
                # stream of the composition
                if smod.stream_fast_path(sess.cm) is None:
                    raise PintTpuError(
                        "composition has no incremental streaming path "
                        "(quantized/chromatic correlated basis); "
                        "ObserveSession serves such appends through the "
                        "warm refit rung"
                    )
                key = (
                    "append", sess.composition, sess.bucket, sess.mode,
                )
            else:
                raise PintTpuError(f"unknown serve op {req.op!r}")
            p.bundle = padded
            deadline = (
                None if req.deadline_s is None
                else p.t_submit + float(req.deadline_s)
            )
            with TRACER.span(
                "serve:admit", "serve", op=req.op,
                flow=req.request_id, bucket=sess.bucket,
            ):
                return self._batcher.add(
                    key, p, time.monotonic(), req.priority, deadline
                )
        except BaseException as e:  # per-request failure, not fatal
            if not p.future.done():
                p.future.set_exception(
                    e if isinstance(e, Exception)
                    else PintTpuError(f"admit failed: {e!r}")
                )
            return None

    def _session_for_request(self, req):
        """Per-par record + composition session + PADDED host bundle +
        TOA count for one request.  The per-par layer resolves first (a
        host parse at worst), then the request's host bundle keys the
        composition AND becomes the dispatch operand — a known
        composition admits with no build."""
        rec = self.sessions.record_for(req.par)
        table = smod.request_table(req.toas, rec.model)
        cpu, host = smod.request_bundles(rec.model, table)
        sess = self.sessions.session_for(rec, table, cpu, self.min_bucket)
        return rec, sess, bmod.pad_bundle_np(host, sess.bucket), cpu.ntoa

    def _check_quota(self, p: _Pending, cid: str):
        """Per-composition admission quota: at most ``quota``
        admitted-but-unresolved requests per composition may occupy the
        pipeline.  Over-quota requests shed typed at admission —
        ``RequestRejected('quota')``, ``serve.quota_rejected`` — and the
        occupancy releases when the future RESOLVES (done callback), not
        when it dispatches."""
        if self.quota <= 0:
            return
        with self._quota_lock:
            n = self._quota_inflight.get(cid, 0)
            if n >= self.quota:
                self._m_quota.inc()
                self._m_rejected.inc()
                TRACER.event(
                    "shed", "serve", reason="quota", op=p.req.op,
                    composition=cid, inflight=n,
                )
                obs_metrics.note_shed_stage("quota", p.stages)
                raise RequestRejected(
                    "quota",
                    f"composition {cid}: {n} in flight >= "
                    f"quota {self.quota}",
                )
            self._quota_inflight[cid] = n + 1
        p.future.add_done_callback(
            lambda _f, cid=cid: self._quota_release(cid)
        )

    def _quota_release(self, cid: str):
        with self._quota_lock:
            n = self._quota_inflight.get(cid, 0)
            if n <= 1:
                self._quota_inflight.pop(cid, None)
            else:
                self._quota_inflight[cid] = n - 1

    def _predict(self, p: _Pending):
        """Polyco phase prediction: generated and cached per par record
        span on the host CPU (``pint_tpu_torch/polycos.py``), evaluated
        host-side — no device batch."""
        from pint_tpu_torch.serve.api import PredictResponse

        req = p.req
        if self._expired(p):
            return
        with TRACER.span("serve:predict", "serve", n=np.size(req.mjds)):
            rec = self.sessions.record_for(req.par)
            pc, cached = rec.polycos_for(req)
            mjds = np.atleast_1d(np.asarray(req.mjds, dtype=np.float64))
            ints, fracs = pc.eval_abs_phase(mjds)
            freq = pc.eval_spin_freq(mjds)
        t_done = time.monotonic()
        # host-only op: the stage vector skips the fabric stages
        stages = dict(p.stages)
        stages["finish"] = t_done
        p.future.set_result(PredictResponse(
            request_id=req.request_id, phase_int=ints,
            phase_frac=fracs, spin_freq_hz=freq, cached=cached,
            wall_ms=(t_done - p.t_submit) * 1e3, stages=stages,
        ))
        self._m_completed.inc()
        self._note_latency(p, t_done, stages)

    def _expired(self, p: _Pending) -> bool:
        dl = p.req.deadline_s
        if dl is None:
            return False
        waited = time.monotonic() - p.t_submit
        if waited < dl:
            return False
        self._m_shed.inc()
        TRACER.event(
            "shed", "serve", reason="deadline", op=p.req.op,
            waited_s=round(waited, 4),
        )
        obs_metrics.note_shed_stage("deadline", p.stages)
        p.future.set_exception(RequestRejected(
            "deadline",
            f"waited {waited:.3f}s >= deadline {dl}s",
        ))
        return True

    def _flush(self, batch):
        """The flush chokepoint: shed expired members, stack operands,
        route the assembled batch onto a fabric replica."""
        if getattr(batch, "slo_closed", False):
            self._m_slo_close.inc()
            TRACER.event(
                "slo-close", "serve", op=batch.key[0],
                n=len(batch.items),
            )
        # batch-close stamp + cause: 'slo' = deadline-margin trigger,
        # 'full' = capacity trigger, 'due' = the max-wait timer
        t_close = getattr(batch, "t_closed", None) or time.monotonic()
        cause = (
            "slo" if getattr(batch, "slo_closed", False)
            else "full" if len(batch.items) >= self.max_batch
            else "due"
        )
        for p in batch.items:
            p.stages["close"] = t_close
            p.stages["close_cause"] = cause
        live = [p for p in batch.items if not self._expired(p)]
        if not live:
            return
        with TRACER.span(
            "serve:flush", "serve", op=batch.key[0], n=len(live),
            bucket=live[0].session.bucket,
        ):
            try:
                work = self._assemble(batch.key, live)
            except BaseException as e:
                for p in live:
                    if not p.future.done():
                        p.future.set_exception(
                            e if isinstance(e, Exception)
                            else PintTpuError(f"assembly failed: {e!r}")
                        )
                return
            self._m_batches.inc()
            self._m_occupancy.observe(len(live))
            self._dispatch(work)

    def _assemble(self, key, live) -> BatchWork:
        """The stacked-dispatch chokepoint: the pulsar-axis stack of
        every live request's padded bundle + per-par reference vectors,
        DISTINCT pars included, as the batch's operands.  Pad slots
        repeat the first live request, so padded rows are copies of a
        served row and stacking stays numerics-neutral."""
        sess = live[0].session
        cap = bmod.capacity_for(len(live), self.max_batch)
        pad = cap - len(live)
        distinct = len({p.record.par_hash for p in live})
        with TRACER.span(
            "serve:stack", "serve", op=key[0], n=len(live), cap=cap,
            distinct_pars=distinct, composition=sess.cid,
        ):
            bundles = [p.bundle for p in live] + [live[0].bundle] * pad
            refs = [p.record.refnum for p in live] \
                + [live[0].record.refnum] * pad
            bstack = bmod.stack_trees(bundles)
            rstack = bmod.stack_trees(refs)
            if key[0] == "append":
                # the third stacked operand is each stream's solver state,
                # frozen basis anchor and live tail count; pad slots
                # repeat live[0]'s row (their outputs are dropped)
                from pint_tpu_torch.serve.stream import append_aux

                auxs = [append_aux(p) for p in live]
                xs = bmod.stack_trees(auxs + [auxs[0]] * pad)
            else:
                xs = np.zeros((cap, sess.cm.nfree))
                if key[0] == "fit":
                    # warm starts: x0 rides as an input of the fit program
                    for j, p in enumerate(live):
                        if p.req.x0 is not None:
                            xs[j] = np.asarray(p.req.x0, np.float64)
        self._m_stack_pars.observe(distinct)
        obs_metrics.counter(
            f"serve.composition.{sess.cid}.batches"
        ).inc()
        work = BatchWork(key, live, (bstack, rstack, xs), sess, cap)
        if key[0] == "append":
            # append groups never cross-key fuse: one stream's state chain
            # stays its own batch
            work.no_fuse = True
        return work

    def _dispatch(self, work: BatchWork):
        """Route one assembled batch (backpressure: when the routed
        replica's queue is full this blocks, the admission queue fills
        and new submissions shed at the edge).  A replica that stops
        accepting mid-wait (quarantine/drain) is excluded and the batch
        re-routes; with no usable replica left, the batch sheds typed —
        never hangs."""
        while True:
            rep = self.router.route(work, exclude=work.excluded)
            if rep is None:
                reason = "shutdown" if self._stop else "no-replica"
                work.shed(
                    reason, "no live replica available for the batch"
                )
                return
            if rep.submit(work, block=True):
                return
            work.excluded.add(rep.rid)

    def _requeue(self, work: BatchWork, source):
        """Fabric callback: re-route a batch its replica could not serve
        (quarantine flush or guard-class batch failure).  Runs on replica
        pipeline threads, so target submission never blocks
        (force=True); exhausted candidates resolve the member futures
        with the original typed error (or shed typed when the batch was
        never attempted)."""
        obs_metrics.counter("serve.fabric.reroutes").inc()
        TRACER.event(
            "reroute", "fabric", frm=source.tag, op=work.key[0],
            n=len(work.live),
        )
        while True:
            rep = self.router.route(work, exclude=work.excluded)
            if rep is None:
                break
            if rep.submit(work, block=False, force=True):
                return
            work.excluded.add(rep.rid)
        if work.last_error is not None:
            work.fail(work.last_error)
        else:
            work.shed(
                "shutdown" if self._stop else "no-replica",
                "no surviving replica for the re-routed batch",
            )

    # -- stage 3: fabric callbacks (replica fence threads) ----------------
    def _validate_batch(self, work: BatchWork, mats, tag: str):
        """Batch-level finite gate with a REPLICA-TAGGED site: a
        non-finite device output (or an injected ``nan`` fault pinned to
        the replica) raises here, marking the replica's health and
        re-routing the whole batch to a surviving replica.  Row-level
        divergence of an individual fit (its per-row freeze flags) stays
        a per-request failure in :meth:`_response`."""
        site = f"serve:{work.key[0]}@{tag}"
        if work.key[0] == "residuals":
            resid, chi2 = mats
            validate_finite(
                {"residuals": resid, "chi2": chi2}, site=site,
                what="served batch (residuals)",
            )
        elif work.key[0] == "append":
            # STATE leaves only: the in-program drift guard rolls a failed
            # row's state back to its finite pre-append input, so a
            # non-finite state here means a sick replica (an injected or
            # device fault), not drift — drift stays a per-row NaN in
            # dx/chi2, refused in _response so ONLY that stream's future
            # fails over to the warm refit rung
            st, _dx, _covn, _nrm, _chi2 = mats
            validate_finite(
                {f"state.{k}": v for k, v in st.items()}, site=site,
                what="served batch (append state)",
            )
        else:
            x, chi2, _cov, _conv, _nbads, _bads = mats
            validate_finite(
                {"x": x, "chi2": chi2}, site=site,
                what="served batch (fit)",
            )

    def _finish_batch(self, work: BatchWork, mats, replica):
        """Resolve every member future of a fenced, validated batch.
        Each member's stage vector closes here: the request's host stamps
        merge with the batch's fabric stamps plus ``finish``."""
        t_done = time.monotonic()
        with self._finish_lock:
            for i, p in enumerate(work.live):
                stages = {**p.stages, **work.stamps,
                          "finish": t_done}
                try:
                    with TRACER.span(
                        "serve:finish", "serve", op=work.key[0],
                        flow=p.req.request_id, replica=replica.tag,
                    ):
                        resp = self._response(
                            work.key, p, i, mats, len(work.live),
                            t_done, replica.tag, stages,
                        )
                        p.future.set_result(resp)
                    self._m_completed.inc()
                    self._note_latency(p, t_done, stages)
                except Exception as e:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _response(self, key, p, i, mats, nlive, t_done, rtag="",
                  stages=None):
        from pint_tpu_torch.serve.api import FitResponse, ResidualsResponse

        req, sess = p.req, p.session
        ntoa = p.ntoa
        wall_ms = (t_done - p.t_submit) * 1e3
        stages = stages if stages is not None else dict(p.stages)
        site = f"serve:{key[0]}"
        if key[0] == "residuals":
            resid, chi2 = mats
            validate_finite(
                {"residuals": resid[i][:ntoa], "chi2": chi2[i]},
                site=site, what="served residuals",
            )
            return ResidualsResponse(
                request_id=req.request_id, ntoa=ntoa,
                residuals_s=resid[i][:ntoa], chi2=float(chi2[i]),
                bucket=sess.bucket, batch_size=nlive, wall_ms=wall_ms,
                replica=rtag, stages=stages,
            )
        if key[0] == "append":
            from pint_tpu_torch.serve.api import AppendResponse

            st, dx, covn, nrm, chi2 = mats
            # the per-row drift refusal: the in-program guard NaN-poisons
            # dx/chi2 (the state already rolled back) — refused HERE so
            # the stream's fallback chain re-serves by a warm refit
            validate_finite(
                {"dx": np.asarray(dx[i]), "chi2": chi2[i]}, site=site,
                what="served append (drift check poisoned the "
                     "incremental solve)",
            )
            no = noffset(sess.cm)
            cov = (
                np.asarray(covn[i])
                / np.outer(np.asarray(nrm[i]), np.asarray(nrm[i]))
            )[no:, no:]
            state_i = {k: np.asarray(v[i]) for k, v in st.items()}
            return AppendResponse(
                request_id=req.request_id,
                ntoa=int(req.ntoa_prev) + ntoa, appended=ntoa,
                names=tuple(sess.cm.free_names),
                deltas=state_i["x"],
                uncertainties=np.sqrt(np.diag(cov)),
                chi2=float(chi2[i]), converged=True,
                refit="incremental", alerts=(),
                bucket=sess.bucket, batch_size=nlive,
                wall_ms=wall_ms, replica=rtag, stages=stages,
                state=state_i,
            )
        # fit: the batched scan result
        x, chi2, (covn, nrm), conv, _nbads, bads = mats
        if np.asarray(bads)[i].any():
            # the shared refusal for the poisoned row
            validate_finite(
                {"chi2": np.asarray([np.nan])}, site=site,
                what="served fit (scan froze on non-finite chi2)",
            )
        validate_finite(
            {"x": x[i], "chi2": chi2[i]}, site=site, what="served fit",
        )
        no = noffset(sess.cm)
        # unnormalize in host IEEE f64 (Fitter._unnorm_cov)
        cov = (
            np.asarray(covn[i])
            / np.outer(np.asarray(nrm[i]), np.asarray(nrm[i]))
        )[no:, no:]
        sigmas = np.sqrt(np.diag(cov))
        # commit against the REQUEST's own par record — the session is
        # composition-shared and holds no per-par identity
        fitted = p.record.commit_clone(
            sess.cm.free_names, x[i], sigmas
        )
        return FitResponse(
            request_id=req.request_id,
            names=tuple(sess.cm.free_names),
            deltas=np.asarray(x[i]), uncertainties=sigmas,
            chi2=float(chi2[i]), converged=bool(conv[i]),
            method="gls", mode=key[3], fitted_par=fitted.as_parfile(),
            ntoa=ntoa, bucket=sess.bucket, batch_size=nlive,
            wall_ms=wall_ms, replica=rtag, stages=stages,
        )

    def _note_latency(self, p, t_done=None, stages=None):
        """Latency attribution chokepoint: the end-to-end figure feeds
        the sliding-window total histogram, each consecutive-stamp delta
        its per-stage WindowHistogram, and the worst-k exemplar
        reservoir keeps the stage vector + flow id of slow requests."""
        t = t_done or time.monotonic()
        lat_ms = (t - p.t_submit) * 1e3
        self._m_latency.observe(lat_ms)
        self._m_lat_total.observe(lat_ms, now=t)
        if stages:
            prev = stages.get("submit", p.t_submit)
            for s in obs_metrics.STAGES[1:]:
                ts = stages.get(s)
                if ts is None:
                    continue
                self._m_lat_stage[s].observe((ts - prev) * 1e3, now=t)
                prev = ts
            self._m_exemplars.offer(
                lat_ms, p.req.request_id, stages, now=t
            )

    def _replay_jobs(self, include_jobs: bool = False) -> list:
        """The warm ledger resolved into pre-warm works ([] with no
        ledger): the boot replay draws from here, and the pool keeps it
        as its replay hook.  Background-job programs (key[0] == 'job')
        are left out unless ``include_jobs``: the job scheduler owns
        those (``JobScheduler.prewarm``)."""
        from pint_tpu_torch.serve import warm_ledger as wlmod

        if self._ledger is None:
            return []
        works = wlmod.replay_jobs(
            self._ledger, self.sessions, self.max_batch
        )
        if not include_jobs:
            works = [w for w in works if w[0].key[0] != "job"]
        return works

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        """One-look serving telemetry.  ``p50_ms``/``p99_ms`` read the
        sliding-window total-latency histogram; ``latency`` breaks the
        same window down per stage plus the shed-reason x stage table."""
        def pct(q):
            v = self._m_lat_total.percentile(q)
            return None if v is None else round(v, 3)

        occ = self._m_occupancy.value
        stack = self._m_stack_pars.value
        mc = obs_metrics.counter
        per_replica = self.pool.stats()
        return {
            "requests": self._m_requests.value,
            "completed": self._m_completed.value,
            "shed": self._m_shed.value,
            "rejected": self._m_rejected.value,
            "batches": self._m_batches.value,
            "batch_occupancy_mean": (
                None if not occ["count"]
                else round(occ["sum"] / occ["count"], 3)
            ),
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "latency": {
                "window_s": self._m_lat_total.window_s,
                "count": self._m_lat_total.count,
                "stages": {
                    s: {
                        "p50_ms": (
                            None if (v := h.percentile(0.50)) is None
                            else round(v, 3)
                        ),
                        "p99_ms": (
                            None if (v := h.percentile(0.99)) is None
                            else round(v, 3)
                        ),
                    }
                    for s, h in self._m_lat_stage.items()
                    if h.count
                },
                "shed_stages": {
                    name[len("serve.shed_stage."):]: v
                    for name, v in obs_metrics.snapshot().items()
                    if name.startswith("serve.shed_stage.") and v
                },
                "exemplars": self._m_exemplars.value,
            },
            "sessions": len(self.sessions),
            "kernels": sum(
                r["kernels"] for r in per_replica.values()
            ),
            "population": {
                "pars": self.sessions.npars,
                "pars_served": mc("serve.session.pars_served").value,
                "par_evictions": mc(
                    "serve.session.par_evictions"
                ).value,
                "compositions": self.sessions.ncompositions,
                "stack_distinct_mean": (
                    None if not stack["count"]
                    else round(stack["sum"] / stack["count"], 3)
                ),
            },
            "fabric": {
                "replicas": self.pool.size,
                "live": len(self.pool.live),
                "routes": mc("serve.fabric.routes").value,
                "reroutes": mc("serve.fabric.reroutes").value,
                "spills": mc("serve.fabric.spills").value,
                "quarantines": mc("serve.fabric.quarantines").value,
                "readmits": mc("serve.fabric.readmits").value,
                "probes": mc("serve.fabric.probes").value,
                "coalesced": mc("serve.fabric.coalesced").value,
                **self.router.stats(),
                "per_replica": per_replica,
            },
            "slo": {
                "early_closes": mc("serve.slo.early_close").value,
                "late_sheds": mc("serve.shed.late").value,
                "quota_rejected": mc("serve.quota_rejected").value,
            },
            # the warm-restart ledger's record and replay accounting
            "warm": {
                "recorded": mc("serve.warm.recorded").value,
                "replayed": mc("serve.warm.replayed").value,
                "failed": mc("serve.warm.failed").value,
                "stale": mc("serve.warm.stale").value,
                "replay_s": self.replay_s,
            },
            # O(append) streaming: which fallback rung served each tail
            "stream": {
                "open": len(self._streams),
                "appends": mc("serve.stream.appends").value,
                "incremental": mc("serve.stream.incremental").value,
                "warm_refits": mc("serve.stream.warm_refit").value,
                "cold_refits": mc("serve.stream.cold_refit").value,
                "refreshes": mc("serve.stream.refresh").value,
                "alerts": mc("serve.stream.alerts").value,
                "drift_fallbacks": mc(
                    "serve.stream.drift_fallback"
                ).value,
                "cold_fallbacks": mc(
                    "serve.stream.cold_fallback"
                ).value,
            },
            # the background compute class
            "jobs": self._jobs.stats(),
        }

    def reset_stats(self):
        """Scope stats() to a fresh measurement window: zeroes the
        serve.* metric namespace (the sliding-window latency histograms
        and the exemplar reservoir included).  Sessions and programs are
        untouched — this resets observation, not state."""
        obs_metrics.reset("serve.")

    def close(self, timeout: float = 120.0):
        """Drain and stop: queued work is flushed onto the fabric
        (deadlines still honored), the collector joins, then the replica
        pool drains — in-flight batches fence and queued work completes
        or sheds as typed RequestRejected('shutdown')."""
        from pint_tpu_torch.serve import warm_ledger as wlmod

        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._collector.join(timeout)
        # the job scheduler stops BEFORE the pool drains: running jobs
        # checkpoint and shed typed, so no quantum is in flight while the
        # replicas drain
        self._jobs.stop()
        self.pool.drain(timeout)
        with self._streams_lock:
            exc, self._stream_exec = self._stream_exec, None
        if exc is not None:
            exc.shutdown(wait=True)
        if self._ledger is not None:
            wlmod.unregister(self._ledger)
            self._ledger = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
