"""Per-device replica executor for the serving fabric.

Counterpart of ``pint_tpu/serve/fabric/replica.py``.  A *replica* is one
device's share of the serving engine: it owns the program cache for
every session group routed to it (each replica builds, and on the card
captures, its OWN programs), a bounded work queue + inflight semaphore
forming its private dispatch pipeline (dispatcher thread: operands to the
device and the guarded launch; fencer thread: the watchdog, the read,
validation and resolution), and a health state machine driven by the
``runtime/guard.py`` outcomes:

``LIVE → DEGRADED``
    one guard-class failure (watchdog trip / retries exhausted /
    non-finite validation) degrades the replica — it keeps serving, but
    the router prefers LIVE peers, and the pool's prober canaries it so
    an avoided replica still converges to LIVE (canary passes) or
    QUARANTINED (canary failures accumulate);
``DEGRADED → QUARANTINED``
    ``quarantine_n`` CONSECUTIVE failures quarantine it: queued work is
    re-routed to surviving replicas, new routing skips it, and the pool's
    background canary probe (a small guarded launch on the same device,
    so injected or real faults keep failing it) re-admits it once the
    device answers sanely again;
``→ DRAINING``
    the reshape fence (``ReplicaPool.repartition``): the router stops
    placing new work here, the dispatcher keeps running until the queue
    empties (outstanding work resolves, or re-routes on failure bounded
    by the pool width — in-flight futures are never dropped), and the
    pool then retires the executor with :meth:`drain`.  Entered via
    :meth:`begin_drain`; never goes back to a serving state;
``→ DRAINED``
    terminal shutdown state: in-flight batches fence, queued work
    completes (or sheds as typed RequestRejected) — never hangs.

Failure handling is per BATCH: a failed batch re-routes to another
replica (its ``excluded`` set grows, so the bounce is bounded by the pool
width); only when no candidate remains do the member futures see the
original typed error.  Deterministic failures (model errors) are the
request's own fault — they fail the futures immediately and never damage
replica health.

In-replica batch coalescing: when the dispatcher pops a batch and finds
MORE same-key batches queued behind it, it merges them into one stacked
dispatch along the capacity axis (:func:`merge_batch_works`) — only onto
capacities this replica has ALREADY built a program for, so steady state
never builds or captures (``replica:coalesce`` span,
``serve.fabric.coalesced`` counter; ``PINT_TPU_SERVE_COALESCE=0``
disables it).  Transfer overlap: the next batch's operands go to the
device BEFORE the inflight semaphore, while earlier batches still compute
(``replica:place`` span, ``serve.fabric.overlapped``;
``PINT_TPU_SERVE_OVERLAP=0`` places after acquiring).

Cross-key fusion: where the coalescer deepens ONE key's batch, the fuser
widens across keys — up to ``PINT_TPU_SERVE_XKEY_MAX`` co-resident queued
batches of DISTINCT (key, capacity) identities, every bucket at or below
``PINT_TPU_SERVE_XKEY_THRESHOLD``, dispatch as ONE program that runs the
members' bodies in turn (``serve/session.py::build_fused_kernel``; on the
card one captured graph), cached under the sorted member-identity combo.
A fusion lands only when the combo program is already built OR every
member's solo program is, so a steady state never builds; results
de-multiplex per member, bitwise those of separate dispatches.  A member
that fails its fence is marked ``no_fuse`` and re-routed solo; the others
resolve.  ``replica:xkey-fuse`` span, ``serve.fabric.xkey_fused`` counter,
``serve.fabric.xkey_members`` histogram; ``PINT_TPU_SERVE_XKEY_FUSE=0``
disables it.

On the card (what the port adds to the reference's executor):

- **A stream of its own.**  The dispatcher makes the replica's
  ``torch.cuda.Stream`` current: operands copy from pinned staging
  without blocking, the programs replay on it, and an event recorded
  after a batch's launches is what its fence waits for.  Reads run on a
  second stream after that event, so a fence never waits for the batch
  dispatched behind it.
- **The watchdog across threads.**  The guard keeps each call's deadline
  on the thread that launched it; the dispatcher hands the batch's
  deadlines (``guard.take_deadlines``) to the fencer with its outputs,
  and the fencer keeps them and the batch's done event
  (``guard.wait_deadlines``) before any read:
  a wedged batch ends in GuardTimeout at the fence, its program is
  dropped (``on_wedged``), and the replica degrades and re-routes the
  work.  An injected ``hang`` at the batch's site becomes a kernel that
  spins on the replica's stream for the hang's seconds (a wedged launch
  the fence must see); on the CPU it is the guard's host hang.
- **Captures in turns.**  A capture runs in CUDA's global mode, where a
  device call from another thread invalidates it, so dispatch, the
  fence's read, canary and session builds take the device's lock
  (``runtime/graphs.py::device_lock``) that every capture holds.  The
  fence asks its events through the device's capture gate
  (``capture_gate``) instead: it waits only while a capture segment is
  open, never for a whole capture, so a watchdog shorter than a capture
  is not taken for a wedge.

Operands are fresh device tensors per batch that the program copies into
its static inputs, and a program's outputs are copies: two batches in
flight on one program cannot overwrite each other (the reference's
donation has no counterpart here).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import queue
import threading
import time

import numpy as np
import torch

from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import (
    GuardTimeout,
    PintTpuError,
    PintTpuNumericsError,
    RequestRejected,
    RetriesExhausted,
    TransientDispatchError,
)
from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import faults, guard, lockwitness
from pint_tpu_torch.runtime.graphs import (
    ProgramCache,
    capture_gate,
    device_lock,
)
from pint_tpu_torch.serve.batcher import tree_map

#: health states
LIVE = "LIVE"
DEGRADED = "DEGRADED"
QUARANTINED = "QUARANTINED"
DRAINING = "DRAINING"
DRAINED = "DRAINED"


def health_kind(e: BaseException) -> str | None:
    """Classify a batch failure for the health machine: 'watchdog'
    (wedged launch — the guard already retried transients), 'nan'
    (non-finite device output), or None (deterministic — the request's
    own fault, e.g. a model error: fail the futures, leave replica health
    alone)."""
    if isinstance(e, (GuardTimeout, RetriesExhausted,
                      TransientDispatchError)):
        return "watchdog"
    if isinstance(e, PintTpuNumericsError):
        return "nan"
    return None


#: batch flow ids — one per assembled BatchWork, so the fabric-side spans
#: of one dispatch stitch into a Perfetto flow arc
_BATCH_IDS = itertools.count()


class BatchWork:
    """One assembled micro-batch flowing through the fabric: the
    flush-time stacked host-numpy operands plus the routing state
    (replicas that already failed it, the last typed error).

    ``stamps`` is the batch half of the request stage clock: monotonic
    stamps at route/queue/place/dispatch/fence, merged into each member's
    stages at resolution."""

    __slots__ = ("key", "live", "ops", "session", "cap", "excluded",
                 "last_error", "stamps", "flow", "no_fuse")

    def __init__(self, key, live, ops, session, cap):
        self.key = key
        self.live = live  # engine _Pending records
        self.ops = ops  # (bundle stack, (refvecs, flatvecs), x0 stack)
        self.session = live[0].session if session is None else session
        self.cap = cap
        self.excluded: set = set()  # replica ids that failed/refused
        self.last_error: BaseException | None = None
        self.stamps: dict = {}  # stage name -> time.monotonic()
        self.flow = f"batch-{next(_BATCH_IDS)}"
        # a fused dispatch of this batch failed: it retries solo only
        self.no_fuse = False

    def stamp(self, name: str):
        """Record one stage boundary.  Re-routes re-stamp earlier stages
        (route/queue/place fire again on the next replica) — the
        overwrite keeps the vector monotonic."""
        self.stamps[name] = time.monotonic()

    def flush_stages(self):
        """Fold the batch stamps into each member's own stage dict —
        called wherever the batch object is about to be REPLACED
        (coalesce merge) so no member loses recorded boundaries."""
        for p in self.live:
            stages = getattr(p, "stages", None)
            if stages is not None:
                stages.update(self.stamps)

    @property
    def op(self) -> str:
        """The request kind: 'residuals', 'fit', 'append', ..."""
        return self.key[0]

    def kernel_key(self) -> tuple:
        return (self.key, self.cap)

    def site(self, tag: str) -> str:
        """The guard site of this batch's program on replica ``tag``
        (spans and faults pin to it)."""
        return (f"serve:{self.key[0]}:b{self.session.bucket}"
                f"x{self.cap}@{tag}")

    def make_kernel(self, programs, tag: str):
        """Build this batch's kernel in one replica's program cache."""
        from pint_tpu_torch.serve import session as smod

        site = self.site(tag)
        if self.key[0] == "fit":
            _, _, _, mode, maxiter, tol = self.key
            return smod.build_fit_kernel(
                self.session, mode, maxiter, tol, self.ops, programs,
                self.kernel_key(), site,
            )
        if self.key[0] == "append":
            return smod.build_append_kernel(
                self.session, self.ops, programs, self.kernel_key(), site,
            )
        return smod.build_residuals_kernel(
            self.session, self.key[3], self.ops, programs,
            self.kernel_key(), site,
        )

    def fail(self, e: BaseException):
        """Resolve every member future with the typed failure."""
        exc = (
            e if isinstance(e, Exception)
            else PintTpuError(f"fabric dispatch failed: {e!r}")
        )
        for p in self.live:
            if not p.future.done():
                p.future.set_exception(exc)

    def shed(self, reason: str, detail: str):
        """Typed load-shed of the whole batch (no replica can serve)."""
        obs_metrics.counter("serve.rejected").inc(len(self.live))
        if reason == "no-replica":
            obs_metrics.counter("serve.fabric.no_replica").inc()
        TRACER.event(
            "shed", "fabric", reason=reason, op=self.key[0],
            n=len(self.live), flow=self.flow,
        )
        for p in self.live:
            if not p.future.done():
                obs_metrics.note_shed_stage(
                    reason,
                    {**getattr(p, "stages", {}), **self.stamps},
                )
                p.future.set_exception(RequestRejected(reason, detail))


def _pow2_capacity(n: int) -> int:
    """Smallest power of two >= n — the fabric's capacity grid
    (batcher.capacity_for without the engine's max_batch clamp: the
    coalescer's warmed-program gate bounds growth instead)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _repad(rows, cap: int):
    pad = cap - rows.shape[0]
    if pad:
        rows = np.concatenate(
            [rows, np.repeat(rows[:1], pad, axis=0)], axis=0
        )
    return rows


def merge_batch_works(works: list[BatchWork], cap: int) -> BatchWork:
    """Merge co-resident same-key batches into ONE stacked work along the
    capacity axis.

    Row discipline: each source work's operand leaves carry ``w.cap``
    rows of which only the first ``len(w.live)`` are real (the engine
    pads by repeating live[0]'s row; x0 pad rows are zeros).  The merge
    STRIPS every source's pad rows and concatenates the real rows in
    works order, so merged row ``i`` stays aligned with
    ``merged.live[i]``; it is then re-padded to ``cap`` by repeating its
    own row 0, as ``TimingEngine._assemble`` would have stacked the
    combined live set."""
    live = [p for w in works for p in w.live]
    if len(live) > cap:
        raise PintTpuError(
            f"coalesce overflow: {len(live)} live rows > capacity {cap}"
        )
    counts = [len(w.live) for w in works]

    def merge(*leaves):
        return _repad(np.concatenate(
            [np.asarray(leaf)[:n] for leaf, n in zip(leaves, counts)],
            axis=0,
        ), cap)

    ops = tree_map(merge, *[w.ops for w in works])
    # the merged batch REPLACES the sources: flush each source's stage
    # stamps onto its own members first, then re-stamp the merged
    # dispatch's later stages on the new object
    for w in works:
        w.flush_stages()
    merged = BatchWork(works[0].key, live, ops, works[0].session, cap)
    merged.excluded = set().union(*(w.excluded for w in works))
    merged.no_fuse = any(w.no_fuse for w in works)
    merged.flow = works[0].flow
    return merged


class FusedBatch:
    """A cross-key fused dispatch in flight: member BatchWorks in combo
    (sorted-identity) order — the fused program's operand and output
    order — plus the program-cache combo key.  Members keep their own
    ``_outstanding`` units and fence and resolve independently."""

    __slots__ = ("members", "combo")

    def __init__(self, members, combo):
        self.members = tuple(members)
        self.combo = combo


#: cycles of the device's clock per second, measured once per device by
#: timing a spin (the injected-hang wedge)
_SPIN_RATE: dict = {}


def _spin(seconds: float, device) -> None:
    """Queue a kernel that spins ``seconds`` on the current stream: an
    injected hang as a wedged launch on the device."""
    rate = _SPIN_RATE.get(device)
    if rate is None:
        cycles = 10_000_000
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(cycles)
        e.record()
        e.synchronize()
        rate = _SPIN_RATE[device] = cycles / (s.elapsed_time(e) / 1e3)
    torch.cuda._sleep(int(seconds * rate))


class Replica:
    """One device's executor: program cache + dispatch pipeline + health
    state machine.

    ``requeue(work, replica)`` re-routes a batch this replica could not
    serve; ``finisher(work, mats, replica)`` resolves futures from fenced
    host arrays; ``validator(work, mats, tag)`` is the batch-level finite
    gate (engine-provided so the response schema stays in one place)."""

    def __init__(self, rid: int, device, *, inflight: int,
                 quarantine_n: int, requeue, finisher, validator,
                 tag: str | None = None):
        self.rid = rid
        # an executor owns a device SET: the plain replica is the width-1
        # case and a gang (fabric/gang.py) the width-N one; ``device``
        # is the lead device, where solo work runs
        devices = (tuple(device) if isinstance(device, (tuple, list))
                   else (device,))
        self.devices = tuple(torch.device(d) for d in devices)
        self.width = len(self.devices)
        self.device = self.devices[0]
        self.tag = tag if tag is not None else f"r{rid}"
        self.inflight = max(1, int(inflight))
        self.quarantine_n = max(1, int(quarantine_n))
        self._requeue = requeue
        self._finisher = finisher
        self._validator = validator
        self._cuda = self.device.type == "cuda"
        # the replica's own stream (launches) and fence stream (reads)
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._fence_stream = (torch.cuda.Stream(self.device) if self._cuda
                              else None)
        self.programs = ProgramCache(self.device)
        self._cond = lockwitness.wrap(
            threading.Condition(), "Replica._cond"
        )
        self._queue: collections.deque = collections.deque()
        self._fence_q: queue.Queue = queue.Queue()
        self._sem = threading.BoundedSemaphore(self.inflight)
        self._kernels: dict = {}  # (batch key, capacity) -> kernel; dispatcher-thread only
        self._coalesce_on = (
            os.environ.get("PINT_TPU_SERVE_COALESCE", "1") != "0"
        )
        self._overlap_on = (
            os.environ.get("PINT_TPU_SERVE_OVERLAP", "1") != "0"
        )
        self._xkey_on = (
            os.environ.get("PINT_TPU_SERVE_XKEY_FUSE", "1") != "0"
        )
        self._xkey_threshold = int(
            os.environ.get("PINT_TPU_SERVE_XKEY_THRESHOLD", "4096")
        )
        self._xkey_max = max(2, int(
            os.environ.get("PINT_TPU_SERVE_XKEY_MAX", "4")
        ))
        self._draining = False
        # health state: reads are bare attribute loads (GIL-atomic) so
        # submit() can check state while holding only _cond; writes go
        # through _set_state under _state_lock
        self._state = LIVE
        self._state_lock = lockwitness.wrap(
            threading.Lock(), "Replica._state_lock"
        )
        self._consecutive = 0
        # background-quantum occupancy: raised by the job scheduler
        # around each quantum (note_background); the router folds it
        # into the load so interactive placement avoids an executor busy
        # with background work.  Reads are bare attribute loads
        self.background = 0
        self.batches_done = 0  # fencer-thread only
        self.failures = 0
        #: (op, capacity, CUDA-event ms from a batch's first launch to its
        #: last) of the latest batches; empty on the CPU
        self.device_ms: collections.deque = collections.deque(maxlen=256)
        self._outstanding = 0  # batches queued + in flight
        self._g_out = obs_metrics.gauge(
            f"serve.replica.{rid}.outstanding"
        )
        self._g_state = obs_metrics.gauge(f"serve.replica.{rid}.state")
        self._g_state.set(LIVE)
        self._m_batches = obs_metrics.counter(
            f"serve.replica.{rid}.batches"
        )
        self._canary = self._make_canary()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"pint-tpu-replica {self.tag} dispatch",
        )
        self._fencer = threading.Thread(
            target=self._fence_loop, daemon=True,
            name=f"pint-tpu-replica {self.tag} fence",
        )
        self._dispatcher.start()
        self._fencer.start()

    # -- introspection (router/stats read these lock-free) ---------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def outstanding(self) -> int:
        return self._outstanding

    @property
    def kernel_count(self) -> int:
        return len(self._kernels)

    # -- admission ---------------------------------------------------------
    def submit(self, work: BatchWork, block: bool = True,
               force: bool = False) -> bool:
        """Enqueue one assembled batch; returns False when the replica is
        not accepting (draining/quarantined — the caller re-routes).  A
        full queue blocks (bounded wait-poll, so a mid-wait quarantine is
        noticed) unless ``force`` (the requeue path must never block a
        peer replica's pipeline thread on this one)."""
        with TRACER.span(
            "replica:submit", "fabric", replica=self.tag,
            op=work.key[0], n=len(work.live), flow=work.flow,
        ):
            with self._cond:
                while True:
                    if self._draining or self._state == QUARANTINED:
                        return False
                    if force or len(self._queue) < self.inflight:
                        break
                    if not block:
                        return False
                    self._cond.wait(0.05)
                work.stamp("queue")  # stage clock: accepted here
                self._queue.append(work)
                self._outstanding += 1
                self._g_out.set(self._outstanding)
                self._cond.notify_all()
        return True

    # -- the dispatch pipeline --------------------------------------------
    def _kernel_cache_key(self, work: BatchWork) -> tuple:
        """The key of ``work``'s program in this executor's kernel cache:
        (group key, capacity) on a width-1 replica (a gang adds its shape
        and placement mode)."""
        return work.kernel_key()

    def _warmed(self, key, cap: int) -> bool:
        """Whether a (group key, capacity) program is already built on
        this executor (the coalescer's build-free gate).
        Dispatcher-thread only."""
        return (key, cap) in self._kernels

    def _kernel_for(self, work: BatchWork):
        kkey = self._kernel_cache_key(work)
        k = self._kernels.get(kkey)
        if k is None:
            from pint_tpu_torch.serve import session as smod
            from pint_tpu_torch.serve import warm_ledger as wlmod

            inner = work.make_kernel(self.programs, self.tag)
            obs_metrics.counter(
                f"serve.composition.{work.session.cid}.compiles"
            ).inc()
            warm = (work.session, work.key, work.cap, self.tag)
            noted = [False]

            def ledgered(*args):
                out = inner(*args)
                if not noted[0]:
                    # the warm ledger's write-through, at the program's
                    # first (building, capturing) call
                    noted[0] = True
                    wlmod.note_warm(*warm)
                return out

            k = smod.serialized(ledgered, work.session.trace_lock,
                                self._cuda)
            self._kernels[kkey] = k
        return k

    def _dispatch_loop(self):
        TRACER.name_thread(f"replica {self.tag} dispatch")
        if self._cuda:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.stream)
        while True:
            with self._cond:
                while not self._queue and not self._draining:
                    self._cond.wait(0.2)
                if not self._queue:
                    break  # draining and empty
                work = self._queue.popleft()
                self._cond.notify_all()
            if self._state == QUARANTINED and not self._draining:
                # quarantined with leftover queue (submit race): hand the
                # work back to the router
                self._batch_leaves(work)
                self._requeue(work, self)
                continue
            job = self._fuse(self._coalesce(work))
            if isinstance(job, FusedBatch):
                self._run_fused(job)
            else:
                self._run(job)
        self._fence_q.put(None)

    def _coalesce(self, work: BatchWork) -> BatchWork:
        """In-replica batch coalescing: absorb queued same-key batches
        into ``work``'s stacked dispatch.  A candidate is absorbed only
        when the grown ``(key, capacity)`` is ALREADY in this replica's
        program cache, so the no-build invariant holds by construction
        (a cold capacity keeps its batches separate and warms normally).
        Dispatcher-thread only; queue surgery under ``_cond``."""
        if not self._coalesce_on:
            return work
        picked: list[BatchWork] = []
        total = len(work.live)
        cap = work.cap
        with self._cond:
            if self._queue:
                keep: collections.deque = collections.deque()
                for w in self._queue:
                    grown = max(
                        cap, _pow2_capacity(total + len(w.live))
                    )
                    if (w.key == work.key
                            and self._warmed(work.key, grown)):
                        picked.append(w)
                        total += len(w.live)
                        cap = grown
                    else:
                        keep.append(w)
                if picked:
                    self._queue = keep
                    # absorbed batches leave the queue here; the merged
                    # batch gets the single remaining _batch_leaves at
                    # completion, balancing submit()'s one increment each
                    self._outstanding = max(
                        0, self._outstanding - len(picked)
                    )
                    self._g_out.set(self._outstanding)
                    self._cond.notify_all()
        if not picked:
            return work
        with TRACER.span(
            "replica:coalesce", "fabric", replica=self.tag,
            op=work.key[0], absorbed=len(picked), n=total, cap=cap,
        ):
            merged = merge_batch_works([work] + picked, cap)
        obs_metrics.counter("serve.fabric.coalesced").inc(len(picked))
        obs_metrics.histogram("serve.fabric.coalesce_depth").observe(
            total
        )
        return merged

    def _fusible(self, work: BatchWork) -> bool:
        """Small-batch fusion eligibility: at or below the bucket cutoff
        (key[2] is the group's TOA bucket) and not a fused-failure
        retry."""
        return (not work.no_fuse
                and int(work.key[2]) <= self._xkey_threshold)

    def _fuse(self, work: BatchWork):
        """Cross-key fusion: widen the dispatch across DISTINCT (key,
        capacity) identities the coalescer cannot touch.  Scans the queue
        for up to ``_xkey_max - 1`` fusible co-resident batches whose
        identities differ from ``work``'s and each other's, forms the
        sorted-identity combo, and fuses only when the combo program is
        already built on this replica OR every member's solo program is —
        the coalescer's gate lifted to the combo, so a steady state never
        builds (the one build of a combo runs off solo-warmed members).
        Candidates stay queued when the gate fails.  Members keep their
        individual ``_outstanding`` units.  Dispatcher-thread only; queue
        surgery under ``_cond``.  -> a FusedBatch, or ``work``."""
        if not self._xkey_on or not self._fusible(work):
            return work
        with self._cond:
            if not self._queue:
                return work
            seen = {work.kernel_key()}
            cands: list[BatchWork] = []
            for w in self._queue:
                if len(cands) + 2 > self._xkey_max:
                    break
                kk = w.kernel_key()
                if self._fusible(w) and kk not in seen:
                    cands.append(w)
                    seen.add(kk)
            if not cands:
                return work
            order = sorted([work] + cands,
                           key=lambda w: repr(w.kernel_key()))
            combo = ("xkey",) + tuple(w.kernel_key() for w in order)
            if combo not in self._kernels and not all(
                    self._kernel_cache_key(w) in self._kernels
                    for w in order):
                return work
            for w in cands:
                self._queue.remove(w)
            self._cond.notify_all()
        n = sum(len(w.live) for w in order)
        with TRACER.span(
            "replica:xkey-fuse", "fabric", replica=self.tag,
            members=len(order), n=n,
        ):
            fused = FusedBatch(order, combo)
        obs_metrics.counter("serve.fabric.xkey_fused").inc(len(cands))
        obs_metrics.histogram("serve.fabric.xkey_members").observe(
            len(order)
        )
        return fused

    def _shed_late(self, work: BatchWork):
        """Dispatch-boundary deadline re-check: a member that expired
        while its batch sat in this replica's queue sheds typed HERE,
        before the device sees the batch (``serve.shed.late``); survivors
        keep dispatching through the SAME (key, capacity) program — their
        rows gathered in order and re-padded by repeating row 0 — so row
        ``i`` stays aligned with ``live[i]`` and the shed never builds a
        program.  Returns None when every member expired."""
        now = time.monotonic()
        flags = [
            p.req.deadline_s is not None
            and now - p.t_submit >= p.req.deadline_s
            for p in work.live
        ]
        if not any(flags):
            return work
        expired = [p for p, f in zip(work.live, flags) if f]
        obs_metrics.counter("serve.shed.late").inc(len(expired))
        obs_metrics.counter("serve.shed").inc(len(expired))
        TRACER.event(
            "shed", "fabric", reason="deadline-late", op=work.key[0],
            replica=self.tag, n=len(expired), flow=work.flow,
        )
        for p in expired:
            if not p.future.done():
                obs_metrics.note_shed_stage(
                    "deadline-late",
                    {**getattr(p, "stages", {}), **work.stamps},
                )
                waited = now - p.t_submit
                p.future.set_exception(RequestRejected(
                    "deadline",
                    f"expired at the dispatch boundary: waited "
                    f"{waited:.3f}s >= deadline {p.req.deadline_s}s",
                ))
        keep_idx = [i for i, f in enumerate(flags) if not f]
        if not keep_idx:
            self._batch_leaves(work)
            return None
        cap = work.cap
        kept = BatchWork(
            work.key,
            [p for p, f in zip(work.live, flags) if not f],
            tree_map(lambda leaf: _repad(np.asarray(leaf)[keep_idx], cap),
                     work.ops),
            work.session, cap,
        )
        kept.excluded = set(work.excluded)
        kept.last_error = work.last_error
        kept.no_fuse = work.no_fuse
        # survivors keep every boundary already recorded on the shed
        # batch (route/queue)
        kept.stamps = dict(work.stamps)
        kept.flow = work.flow
        return kept

    def _place_ops(self, work: BatchWork) -> list:
        """The stacked host operands as this replica's device tensors,
        the program's leaves in order.  On the card each goes through
        pinned staging and copies without blocking on the replica's
        stream (the caller holds the device's lock)."""
        out = []

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self._cuda:
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)

        tree_map(put, work.ops)
        return out

    def _launch(self, work: BatchWork, kernel, ops, site=None):
        """Launch one batch: -> (outputs, handed-over deadlines, (start,
        done) events).  The caller holds the device's lock."""
        events = None
        if self._cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
            hang = faults.take_hang(site or work.site(self.tag))
            if hang is not None:
                _spin(hang, self.device)  # a wedged launch
        try:
            out = kernel(*ops)
        except BaseException:
            guard.take_deadlines()  # a partial launch's: dropped
            raise
        deadlines = guard.take_deadlines()
        if events is not None:
            events[1].record()
        return out, deadlines, events

    def prewarm_kernel(self, work: BatchWork) -> None:
        """Warm one (key, capacity) program on this replica before
        traffic arrives: one synthetic batch through the normal guarded
        path (``_kernel_for``, ``_place_ops``), read back here.  Runs on
        the calling thread: the pool calls it before the replica has been
        routed any work (``ReplicaPool.prewarm``)."""
        with TRACER.span(
            "replica:prewarm", "fabric", replica=self.tag,
            op=work.key[0], cap=work.cap, bucket=work.session.bucket,
        ):
            kernel = self._kernel_for(work)
            with device_lock(self.device), self._on_stream():
                out, deadlines, events = self._launch(
                    work, kernel, self._place_ops(work))
            self._read(out, deadlines, events)

    def prewarm_fused(self, works: list) -> bool:
        """Warm ONE cross-key fused combo program off the member batches'
        built solo programs (the combo :meth:`_fuse` would form), so a
        first-seen combo never builds inside a measured window.  False
        (nothing done) when fusion is off, fewer than two members are
        given, or one is not fusible.  The replica must be quiescent (no
        outstanding work), as for :meth:`prewarm_kernel`."""
        if (not self._xkey_on or len(works) < 2
                or not all(self._fusible(w) for w in works)):
            return False
        order = sorted(works, key=lambda w: repr(w.kernel_key()))
        combo = ("xkey",) + tuple(w.kernel_key() for w in order)
        with TRACER.span(
            "replica:prewarm", "fabric", replica=self.tag, op="xkey",
            members=len(order),
        ):
            kernel = self._fused_kernel_for(combo, order)
            with device_lock(self.device), self._on_stream():
                out, deadlines, events = self._launch(
                    order[0], kernel, self._place_flat(order),
                    site=self._fused_site(combo, order))
            self._read(out, deadlines, events)
        return True

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self._cuda
                else contextlib.nullcontext())

    def _run(self, work: BatchWork):
        work = self._shed_late(work)
        if work is None:
            return
        try:
            kernel = self._kernel_for(work)
        except BaseException as e:
            self._batch_leaves(work)
            work.fail(e)
            return
        self._dispatch([work], kernel, work,
                       lambda e: self._batch_error(work, e),
                       op=work.key[0], cap=work.cap)

    def _dispatch(self, works, kernel, item, on_error, site=None,
                  **span):
        """Place, launch and hand to the fence ONE dispatch of
        ``works`` (a batch alone, or a fused batch's members in combo
        order) through ``kernel``; the fence gets ``item``.  With
        transfer overlap the operands go to the device before the
        inflight semaphore, while up to ``inflight`` prior dispatches
        still compute; the semaphore then bounds the dispatches awaiting
        this replica's fence (backpressure), and the launch holds the
        device's lock.  A failure goes to ``on_error(e)``, the inflight
        unit released first."""
        flow = works[0].flow

        def place():
            ops = self._place_flat(works)
            for w in works:
                w.stamp("place")
            return ops

        ops = None
        if self._overlap_on:
            try:
                with TRACER.span(
                    "replica:place", "fabric", replica=self.tag,
                    flow=flow, **span,
                ), device_lock(self.device):
                    ops = place()
                obs_metrics.counter("serve.fabric.overlapped").inc()
            except BaseException as e:
                on_error(e)
                return
        self._sem.acquire()
        try:
            with TRACER.span(
                "replica:dispatch", "fabric", replica=self.tag,
                n=sum(len(w.live) for w in works), flow=flow, **span,
            ), device_lock(self.device):
                if ops is None:
                    ops = place()
                out, deadlines, events = self._launch(
                    works[0], kernel, ops, site=site)
            for w in works:
                w.stamp("dispatch")
        except BaseException as e:
            self._sem.release()
            on_error(e)
            return
        self._fence_q.put((item, out, deadlines, events))

    # -- the cross-key fused dispatch pipeline ----------------------------
    def _fused_site(self, combo, members) -> str:
        from pint_tpu_torch.utils import compute_hash

        return (f"serve:xkey:{compute_hash(repr(combo))[:8]}"
                f"x{len(members)}@{self.tag}")

    def _fused_kernel_for(self, combo: tuple, members):
        """Build-or-fetch the fused program of one sorted member combo.
        Its first call runs every member's body, so it holds EVERY
        distinct member session's trace lock, taken in one global order
        (by the raw locks' identity) so that fusions on other replicas
        cannot deadlock.  Dispatcher-thread only (owns ``_kernels``)."""
        k = self._kernels.get(combo)
        if k is None:
            from pint_tpu_torch.serve import session as smod

            inner = smod.build_fused_kernel(
                [(w.session, w.key, w.ops) for w in members],
                self.programs, combo, self._fused_site(combo, members),
            )
            locks = [lk for _, lk in sorted(
                {lockwitness.lock_id(w.session.trace_lock):
                 w.session.trace_lock for w in members}.items()
            )]
            k = smod.serialized(inner, locks, self._cuda)
            self._kernels[combo] = k
        return k

    def _place_flat(self, members) -> list:
        """The members' placed operand leaves, flat, in combo order: the
        fused program's inputs."""
        flat = []
        for w in members:
            flat.extend(self._place_ops(w))
        return flat

    def _run_fused(self, fused: FusedBatch):
        kept = []
        for w in fused.members:
            w2 = self._shed_late(w)
            if w2 is not None:
                kept.append(w2)
        if len(kept) < len(fused.members):
            # a member expired whole at the dispatch boundary: the combo
            # changed — the survivors dispatch solo rather than building
            # a one-off sub-combo
            for w in kept:
                self._run(w)
            return
        fused = FusedBatch(kept, fused.combo)

        def failed(e):
            self._fused_error([(w, e) for w in fused.members])

        try:
            kernel = self._fused_kernel_for(fused.combo, fused.members)
        except BaseException as e:
            failed(e)
            return
        # ONE dispatch (one inflight unit) for the combo
        self._dispatch(fused.members, kernel, fused, failed,
                       site=self._fused_site(fused.combo, fused.members),
                       op="xkey", members=len(fused.members))

    def _fence_fused(self, fused: FusedBatch, out, deadlines, events):
        """De-multiplex one fused dispatch: member ``i``'s output is
        ``out[i]``.  The dispatch fences once; then each member validates
        and resolves on its own, as the solo fence does, so a non-finite
        member fails only its own futures; the one inflight unit releases
        once.  Fencer-thread only."""
        try:
            with TRACER.span(
                "replica:fence", "fabric", replica=self.tag, op="xkey",
                members=len(fused.members), flow=fused.members[0].flow,
            ):
                mats_all, ms = self._read(out, deadlines, events)
        except BaseException as e:
            self._sem.release()
            self._fused_error([(w, e) for w in fused.members])
            return
        del out
        if ms is not None:
            self.device_ms.append(("xkey", len(fused.members), ms))
        failed: list = []
        any_ok = False
        for w, mats in zip(fused.members, mats_all):
            try:
                w.stamp("fence")
                self._validator(w, mats, self.tag)
            except BaseException as e:
                failed.append((w, e))
                continue
            any_ok = True
            try:
                self._finisher(w, mats, self)
            except BaseException as e:
                w.fail(e)
            self.batches_done += 1
            self._m_batches.inc()
            self._batch_leaves(w)
        self._sem.release()
        if any_ok:
            self.note_success()
        if failed:
            self._fused_error(failed)

    def _fused_error(self, pairs):
        """Failure of (some of) a fused dispatch's members, ``pairs`` =
        [(work, error), ...]: ONE health hit for the one failed dispatch,
        and every member marked ``no_fuse`` before it re-routes, so its
        retry runs the solo path — the fused overlay never wedges a batch
        that would succeed unfused.  Deterministic member errors (kind
        None) fail their own futures, as in ``_batch_error``."""
        health_hit = False
        for w, e in pairs:
            w.last_error = e
            w.excluded.add(self.rid)
            w.no_fuse = True
            self._batch_leaves(w)
            kind = health_kind(e)
            if kind is None:
                w.fail(e)
                continue
            if not health_hit:
                health_hit = True
                with self._state_lock:
                    self.failures += 1
                obs_metrics.counter("serve.fabric.failures").inc()
                self.note_failure(kind, e)
            self._requeue(w, self)

    def _read(self, out, deadlines, events):
        """The fence: keep the batch's deadlines and its done event
        (GuardTimeout for a wedged launch), asking the events through the
        device's capture gate, then read its outputs into host-owned
        arrays on the fence stream, under the device's lock.
        -> (mats, device ms or None)."""
        if not self._cuda:
            return guard.fence_owned(out), None
        start, done = events
        guard.wait_deadlines(deadlines, capture_gate(self.device), done)
        with device_lock(self.device), torch.cuda.stream(self._fence_stream):
            self._fence_stream.wait_event(done)
            mats = guard.fence_owned(out)
            ms = start.elapsed_time(done)
        return mats, ms

    def _fence_loop(self):
        TRACER.name_thread(f"replica {self.tag} fence")
        if self._cuda:
            torch.cuda.set_device(self.device)
        while True:
            item = self._fence_q.get()
            if item is None:
                break
            work, out, deadlines, events = item
            if isinstance(work, FusedBatch):
                self._fence_fused(work, out, deadlines, events)
                continue
            try:
                with TRACER.span(
                    "replica:fence", "fabric", replica=self.tag,
                    op=work.key[0], n=len(work.live), flow=work.flow,
                ):
                    mats, ms = self._read(out, deadlines, events)
                del out
                if ms is not None:
                    self.device_ms.append((work.key[0], work.cap, ms))
                work.stamp("fence")
                self._validator(work, mats, self.tag)
            except BaseException as e:
                self._sem.release()
                self._batch_error(work, e)
                continue
            self._sem.release()
            self.note_success()
            try:
                self._finisher(work, mats, self)
            except BaseException as e:
                work.fail(e)
            self.batches_done += 1
            self._m_batches.inc()
            self._batch_leaves(work)

    def _batch_leaves(self, work: BatchWork):
        with self._cond:
            self._outstanding = max(0, self._outstanding - 1)
            self._g_out.set(self._outstanding)
            self._cond.notify_all()

    def _batch_error(self, work: BatchWork, e: BaseException):
        self._batch_leaves(work)
        kind = health_kind(e)
        work.last_error = e
        work.excluded.add(self.rid)
        if kind is None:
            # deterministic failure: the request's fault, not the
            # replica's — no health hit, no re-route
            work.fail(e)
            return
        # runs on both the dispatcher thread (dispatch failures) and the
        # fencer thread (fence/validate failures)
        with self._state_lock:
            self.failures += 1
        obs_metrics.counter("serve.fabric.failures").inc()
        self.note_failure(kind, e)
        self._requeue(work, self)

    # -- health state machine ---------------------------------------------
    def _set_state(self, new: str, kind: str = ""):
        """The single transition chokepoint (every quarantine/readmit is
        event-instrumented + counted).  Callers hold ``_state_lock``."""
        prev, self._state = self._state, new
        self._g_state.set(new)
        if new == QUARANTINED:
            obs_metrics.counter("serve.fabric.quarantines").inc()
        elif new == LIVE and prev == QUARANTINED:
            obs_metrics.counter("serve.fabric.readmits").inc()
        elif new == DEGRADED:
            obs_metrics.counter("serve.fabric.degraded").inc()
        TRACER.event(
            "replica-state", "fabric", replica=self.tag, frm=prev,
            to=new, kind=kind,
        )

    def note_failure(self, kind: str, err: BaseException = None):
        """One guard-class batch failure: LIVE degrades immediately;
        ``quarantine_n`` consecutive failures quarantine (queued work is
        handed back to the router).  A DRAINING executor keeps its state
        (the reshape fence owns its lifecycle) but hands its queue back
        to the router at once, so a fault mid-drain moves work to the new
        partition instead of failing one queued batch after another."""
        flush = []
        with self._state_lock:
            if self._state == DRAINED:
                return
            if self._state == DRAINING:
                with self._cond:
                    while self._queue:
                        flush.append(self._queue.popleft())
                    self._cond.notify_all()
                if flush:
                    obs_metrics.counter(
                        "serve.fabric.drain_flushes").inc(len(flush))
            else:
                self._consecutive += 1
                if self._state == LIVE:
                    self._set_state(DEGRADED, kind=kind)
                if (self._consecutive >= self.quarantine_n
                        and self._state != QUARANTINED):
                    self._set_state(QUARANTINED, kind=kind)
                    with self._cond:
                        while self._queue:
                            flush.append(self._queue.popleft())
                        self._cond.notify_all()
        for w in flush:
            self._batch_leaves(w)
            self._requeue(w, self)

    def note_success(self):
        if not self._consecutive and self._state == LIVE:
            return
        with self._state_lock:
            self._consecutive = 0
            if self._state == DEGRADED:
                self._set_state(LIVE, kind="recovered")

    def note_background(self, delta: int):
        """The job scheduler's quantum bracket: +1 before a background
        quantum runs on this executor, -1 after (the router's load
        term)."""
        with self._state_lock:
            self.background = max(0, self.background + int(delta))

    def readmit(self):
        """Probe-driven re-admission (pool's canary loop)."""
        with self._state_lock:
            if self._state == QUARANTINED:
                self._consecutive = 0
                self._set_state(LIVE, kind="probe")

    # -- canary probe ------------------------------------------------------
    def _make_canary(self):
        """Small guarded launch on THIS device, on the replica's stream:
        the probe exercises the same chokepoints a real batch does
        (dispatch_guard + its watchdog + validate_finite, replica-tagged
        site), so whatever fault quarantined the replica keeps failing
        the canary until it actually clears."""
        site = f"serve:canary@{self.tag}"
        device = self.device
        fn = guard.dispatch_guard(
            lambda x: torch.sum(x * 2.0 + 1.0), site,
            device_type=device.type,
        )

        def run():
            with device_lock(device), self._on_stream():
                x = torch.arange(8.0, dtype=F64, device=device)
                out = fn(x)
                deadlines = guard.take_deadlines()
            guard.wait_deadlines(deadlines, capture_gate(device))
            with device_lock(device), self._on_stream():
                guard.validate_finite(
                    {"canary": out}, site=site,
                    what="replica canary probe",
                )

        return run

    def probe(self) -> bool:
        """One canary launch; True when the device answered sanely."""
        obs_metrics.counter("serve.fabric.probes").inc()
        try:
            with TRACER.span(
                "replica:probe", "fabric", replica=self.tag
            ):
                self._canary()
            return True
        except BaseException:
            return False

    # -- lifecycle ---------------------------------------------------------
    def begin_drain(self):
        """Enter the DRAINING fence: the router stops placing here,
        ``submit`` refuses new work, and the dispatcher runs until the
        queue is empty — outstanding futures resolve or re-route, never
        drop.  Non-blocking: ``ReplicaPool.repartition`` polls
        ``outstanding`` and then retires the executor with :meth:`drain`.
        Idempotent."""
        with self._state_lock:
            if self._state in (DRAINING, DRAINED):
                return
            self._set_state(DRAINING, kind="reshape")
            with self._cond:
                self._draining = True
                self._cond.notify_all()

    def drain(self, timeout: float = 60.0):
        """Stop accepting, finish (or re-route/shed) queued work, fence
        in-flight batches, join both threads."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._dispatcher.join(timeout)
        self._fencer.join(timeout)
        with self._state_lock:
            if self._state != DRAINED:
                self._set_state(DRAINED, kind="shutdown")
