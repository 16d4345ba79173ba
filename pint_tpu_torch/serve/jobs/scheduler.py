"""The background-job scheduler: admission, idle placement, quanta,
yield under pressure, checkpoint and resume.

Counterpart of ``pint_tpu/serve/jobs/scheduler.py``.  One scheduler
thread per engine owns every admitted :class:`Job` and drives it in
bounded device-time quanta:

- **admission** (``jobs:admit`` span): resolve the request's session as
  interactive traffic does (a known composition admits with no build),
  resolve priors, build the kind's runner, and — when the request names
  a checkpoint path whose file exists — restore its progress (a torn
  file is a reported CheckpointError, never a silent cold start).
- **placement**: quanta go only to replicas the router would call idle
  — interactive plus background load below
  ``PINT_TPU_SERVE_JOBS_IDLE_FLOOR`` — and each quantum raises its
  replica's ``background`` term for its duration, so the router steers
  interactive batches elsewhere meanwhile.  A job sticks to its first
  replica (``job.home``) while that one stays idle: its programs are
  built there.
- **yield** (``job-preempt`` event): under SLO pressure — a positive
  delta in the shed, quota or early-close counters, or a saturated
  replica — the quantum in flight finishes (quanta are bounded), every
  running job checkpoints (``checkpoint.save_job``), and no quantum
  starts until the pressure window (``PINT_TPU_SERVE_JOBS_HOLD_MS``)
  clears.
- **resume** (``job-resume`` event): preempted jobs continue from their
  exact carry — bitwise for MCMC, draw for draw for nested, cursor-exact
  for grids — and across a kill and restart (the warm ledger replays job
  programs at boot, :meth:`prewarm`).

A quantum runs on the scheduler thread, never on a replica's fence
thread, through the replica's program cache and guarded sites
(``serve:job:...@rN``): its launches hold the card's lock, its wait for
the device does not (``serve/session.py::run_fenced``).  Knobs, as the
reference reads them: ``PINT_TPU_SERVE_JOBS`` (``0`` disables),
``_JOBS_MAX``, ``_JOBS_QUEUE``, ``_JOBS_QUANTUM``, ``_JOBS_IDLE_FLOOR``,
``_JOBS_HOLD_MS``, ``_JOBS_TICK_MS``, ``_JOBS_RETRIES``,
``_JOBS_CKPT_EVERY``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from pint_tpu_torch import checkpoint as ckpt
from pint_tpu_torch import obs as _obs
from pint_tpu_torch.bayesian import default_priors_for
from pint_tpu_torch.exceptions import PintTpuError, RequestRejected
from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import guard, lockwitness
from pint_tpu_torch.serve.jobs import kernels as jkmod
from pint_tpu_torch.serve.jobs.api import PREEMPTED, QUEUED, RUNNING, Job
from pint_tpu_torch.serve.jobs.runner import make_runner

#: interactive-pressure signals: a positive delta in any of these since
#: the last tick means the fleet is shedding or straining, and the
#: scheduler yields
PRESSURE_COUNTERS = (
    "serve.shed",
    "serve.shed.late",
    "serve.rejected",
    "serve.quota_rejected",
    "serve.slo.early_close",
)


def _env_f(name: str, default: str) -> float:
    return float(os.environ.get(name, default))


class _Station:
    """One quantum's dispatch handle on one replica: the runner calls
    ``station.call(key, cap, *host_ops)`` (or ``station.mcmc``) and the
    station runs the scheduler's program for (key, cap, replica) with the
    job's operands placed on the replica's device."""

    def __init__(self, sched, job, replica):
        self.sched = sched
        self.job = job
        self.replica = replica

    def _placed(self, host_ops):
        from pint_tpu_torch.serve.batcher import tree_map

        dev = self.replica.device
        out = []

        def put(a):
            out.append(torch.as_tensor(np.ascontiguousarray(a),
                                       device=dev))

        tree_map(put, (self.job.bundle, *self.job.refnum) + tuple(host_ops))
        return out

    def _run(self, key, cap, fn):
        job, r = self.job, self.replica
        from pint_tpu_torch.serve.session import run_fenced

        kern = self.sched._kernel_for(job.session, key, int(cap), r,
                                      job.priors, job.ledgerable,
                                      job.bundle)
        job.stages["place"] = time.monotonic()
        job.stages["dispatch"] = time.monotonic()
        out = run_fenced(lambda: fn(kern), r.device,
                         self.sched._stream(r))
        job.stages["fence"] = time.monotonic()
        return out

    def call(self, key, cap, *host_ops):
        out = self._run(key, cap,
                        lambda kern: kern(*self._placed(host_ops)))
        # the shared non-finite refusal on the surfaces that MUST be
        # finite: a NaN quantum feeds the fault ladder, never the result.
        # Log-posteriors are exempt (-inf is a legitimate out-of-prior
        # value under bounded priors)
        site = jkmod.job_site(key, int(cap), self.replica.tag)
        if key[3] == "grid":
            guard.validate_finite({"chi2": out}, site=site,
                                  what="job quantum")
        elif key[3] == "nested":
            guard.validate_finite({"logl": out}, site=site,
                                  what="job quantum")
        return out

    def mcmc(self, key, walkers, lp, seeds):
        """One MCMC quantum: ``len(seeds)`` replays of the step program
        (``kernels.McmcQuantum``)."""
        def fn(kern):
            ops = self._placed(())
            dev = self.replica.device
            return kern(ops, torch.as_tensor(walkers, device=dev),
                        torch.as_tensor(lp, device=dev), seeds)

        out = self._run(key, 1, fn)
        site = jkmod.job_site(key, 1, self.replica.tag)
        guard.validate_finite({"walkers": out[0], "chain": out[2]},
                              site=site, what="job quantum")
        return out


class JobScheduler:
    """Preemptible background compute over one engine's replicas."""

    def __init__(self, engine):
        env = os.environ.get
        self.engine = engine
        self.enabled = env("PINT_TPU_SERVE_JOBS", "1") != "0"
        self.max_jobs = max(1, int(env("PINT_TPU_SERVE_JOBS_MAX", "2")))
        self.max_queue = max(
            1, int(env("PINT_TPU_SERVE_JOBS_QUEUE", "32"))
        )
        q = env("PINT_TPU_SERVE_JOBS_QUANTUM", "")
        self.quantum = int(q) if q.strip() else None
        self.idle_floor = _env_f("PINT_TPU_SERVE_JOBS_IDLE_FLOOR", "0.5")
        self.hold_s = _env_f("PINT_TPU_SERVE_JOBS_HOLD_MS", "50") / 1e3
        self.tick_s = _env_f("PINT_TPU_SERVE_JOBS_TICK_MS", "5") / 1e3
        self.retries = int(env("PINT_TPU_SERVE_JOBS_RETRIES", "3"))
        self.ckpt_every = max(
            1, int(env("PINT_TPU_SERVE_JOBS_CKPT_EVERY", "1"))
        )
        self._cond = lockwitness.wrap(
            threading.Condition(), "JobScheduler._cond"
        )
        self._pending: list = []  # (req, future)
        self._stop = False
        self._thread = None
        # scheduler-thread state below
        self._jobs: list = []  # admitted Jobs
        self._kernels: dict = {}  # (key, cap, tag) -> program
        self._streams: dict = {}  # replica tag -> the jobs' CUDA stream
        self._rr = 0  # round-robin cursor over runnable jobs
        self._p_last = None  # last pressure-counter total
        self._p_until = 0.0  # pressure hold window end
        self._m_quantum = obs_metrics.window_histogram(
            "serve.jobs.quantum_ms", unit="ms"
        )
        self._g_running = obs_metrics.gauge("serve.jobs.running")
        self._g_queued = obs_metrics.gauge("serve.jobs.queued")

    # -- the request-facing edge (caller threads) -------------------------
    def submit(self, req, fut):
        """Admit one JobRequest into the background class (the engine's
        ``submit`` for op 'job'); bounded queue — past it the job sheds
        typed ``RequestRejected('jobs-queue-full')``."""
        _obs.metrics.counter("serve.jobs.submitted").inc()
        try:
            req.validate()
        except Exception as e:
            _obs.metrics.counter("serve.jobs.rejected").inc()
            fut.set_exception(e)
            return fut
        if not self.enabled:
            _obs.metrics.counter("serve.jobs.rejected").inc()
            fut.set_exception(RequestRejected(
                "jobs-disabled",
                "background jobs are disabled (PINT_TPU_SERVE_JOBS=0)",
            ))
            return fut
        with self._cond:
            if self._stop:
                fut.set_exception(RequestRejected(
                    "shutdown", "engine is closed"
                ))
                return fut
            if len(self._pending) >= self.max_queue:
                _obs.metrics.counter("serve.jobs.rejected").inc()
                fut.set_exception(RequestRejected(
                    "jobs-queue-full",
                    f"{len(self._pending)} jobs queued >= "
                    f"PINT_TPU_SERVE_JOBS_QUEUE={self.max_queue}",
                ))
                return fut
            self._pending.append((req, fut))
            self._g_queued.set(len(self._pending))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="pint-tpu-jobs scheduler",
                )
                self._thread.start()
            self._cond.notify_all()
        return fut

    # -- the scheduler thread ---------------------------------------------
    def _loop(self):
        TRACER.name_thread("jobs scheduler")
        while True:
            with self._cond:
                if self._stop:
                    return
                raw = list(self._pending)
                self._pending.clear()
                self._g_queued.set(0)
                if not raw and not self._jobs:
                    self._cond.wait(0.2)
                    continue
            for req, fut in raw:
                self._admit(req, fut)
            if not self._jobs:
                continue
            if self._pressure():
                self._preempt_all()
                time.sleep(self.tick_s)
                continue
            self._resume_all()
            progressed = self._run_one_quantum()
            self._jobs = [j for j in self._jobs if not j.future.done()]
            self._g_running.set(len(self._jobs))
            if not progressed:
                # no idle replica now: interactive traffic owns them
                time.sleep(self.tick_s)

    # -- admission ---------------------------------------------------------
    def _admit(self, req, fut):
        """Resolve session and runner for one queued request (the
        ``jobs:admit`` span)."""
        job = Job(req, fut)
        job.stages["admit"] = time.monotonic()
        try:
            with TRACER.span(
                "jobs:admit", "jobs", kind=req.kind,
                request_id=req.request_id, flow=job.flow,
            ):
                rec, sess, bundle, _ = \
                    self.engine._session_for_request(req)
                job.record, job.session = rec, sess
                job.bundle, job.refnum = bundle, rec.refnum
                job.prior_tag = rec.par_hash[:12]
                if req.kind in ("mcmc", "nested"):
                    job.priors = (
                        dict(req.priors) if req.priors is not None
                        else default_priors_for(
                            rec.model, list(sess.cm.free_names)
                        )
                    )
                if req.kind == "nested":
                    improper = [
                        n for n in sess.cm.free_names
                        if not hasattr(job.priors[n], "ppf")
                    ]
                    if improper:
                        raise PintTpuError(
                            "nested sampling needs proper priors; "
                            f"{improper} have no prior transform"
                        )
                # MCMC priors are constants of the built program, so only
                # founder-par default-prior programs are replayable from
                # the ledger; grid and nested numerics ride entirely in
                # the (bundle, references) inputs
                job.ledgerable = (
                    req.kind in ("grid_chisq", "nested")
                    or (req.priors is None
                        and rec.par_hash == sess.founder_hash)
                )
                job.runner = make_runner(job, self.quantum)
                self._try_restore(job)
            job.state = QUEUED
            self._jobs.append(job)
            self._g_running.set(len(self._jobs))
            TRACER.event(
                "job-state", "jobs", kind=req.kind, state=QUEUED,
                resumed=job.resumed, flow=job.flow,
            )
        except BaseException as e:
            _obs.metrics.counter("serve.jobs.rejected").inc()
            if not fut.done():
                fut.set_exception(
                    e if isinstance(e, Exception)
                    else PintTpuError(f"job admission failed: {e!r}")
                )

    def _try_restore(self, job):
        """The resume ladder's load rung: no file = fresh start; a
        readable checkpoint restores the runner; a TORN one is a typed
        CheckpointError resolved into the future."""
        path = job.req.checkpoint_path
        if not path:
            return
        try:
            payload = ckpt.load_job(path)
        except FileNotFoundError:
            return
        job.runner.restore(payload)
        job.resumed = True
        _obs.metrics.counter("serve.jobs.restores").inc()

    # -- pressure / placement ----------------------------------------------
    def _pressure(self) -> bool:
        """Whether interactive traffic is under SLO pressure now: a
        positive delta in the shed/quota/early-close counters since the
        last tick, or a saturated replica, opens (or extends) the hold
        window."""
        now = time.monotonic()
        total = sum(
            _obs.metrics.counter(n).value for n in PRESSURE_COUNTERS
        )
        if self._p_last is not None and total > self._p_last:
            self._p_until = now + self.hold_s
        self._p_last = total
        for r in self.engine.pool.live:
            if r.outstanding > r.inflight:
                self._p_until = now + self.hold_s
                break
        return now < self._p_until

    def _idle_executor(self, job):
        """A replica the router calls idle (interactive + background load
        under the floor), preferring the job's sticky home."""
        def load(r):
            return r.outstanding + getattr(r, "background", 0)

        live = [
            r for r in self.engine.pool.live
            if not r.draining and r.tag not in job.excluded
        ]
        if not live and job.excluded:
            # every replica faulted this job once: reopen the pool (the
            # retry budget still bounds the attempts)
            job.excluded.clear()
            live = [r for r in self.engine.pool.live if not r.draining]
        idle = [r for r in live if load(r) < self.idle_floor]
        if not idle:
            return None
        if job.home is not None:
            for r in idle:
                if r.tag == job.home:
                    return r
        return min(idle, key=load)

    # -- quanta ------------------------------------------------------------
    def _run_one_quantum(self) -> bool:
        """Advance one runnable job by one quantum (round robin).  False
        when nothing could progress."""
        runnable = [
            j for j in self._jobs
            if j.state in (QUEUED, RUNNING) and not j.future.done()
        ]
        active = [j for j in runnable if j.state == RUNNING]
        for j in runnable:
            if len(active) >= self.max_jobs:
                break
            if j.state == QUEUED:
                j.state = RUNNING
                active.append(j)
        if not active:
            return False
        job = active[self._rr % len(active)]
        self._rr += 1
        r = self._idle_executor(job)
        if r is None:
            return False
        self._run_quantum(job, r)
        return True

    def _run_quantum(self, job, r):
        """One bounded device-time slice of ``job`` on replica ``r`` (the
        ``jobs:quantum`` span); the replica's background term is raised
        for exactly the quantum's duration."""
        job.stages["route"] = time.monotonic()
        job.home = job.home or r.tag
        r.note_background(1)
        t0 = time.monotonic()
        try:
            with TRACER.span(
                "jobs:quantum", "jobs", kind=job.kind,
                replica=r.tag, quantum=job.quanta, flow=job.flow,
            ):
                job.runner.run_quantum(_Station(self, job, r))
        except Exception as e:
            self._quantum_fault(job, r, e)
            return
        finally:
            r.note_background(-1)
        job.quanta += 1
        _obs.metrics.counter("serve.jobs.quanta").inc()
        self._m_quantum.observe((time.monotonic() - t0) * 1e3)
        if job.quanta % self.ckpt_every == 0 or job.runner.done:
            self._checkpoint(job)
        if job.runner.done:
            self._finish(job)

    def _quantum_fault(self, job, r, e):
        """A failed quantum: typed accounting, avoid the replica, survive
        on the pre-quantum carry (a runner advances only on success), and
        give up typed past the retry budget."""
        job.fault_count += 1
        job.excluded.add(r.tag)
        job.home = None
        _obs.metrics.counter("serve.jobs.faults").inc()
        TRACER.event(
            "job-fault", "jobs", kind=job.kind, replica=r.tag,
            error=type(e).__name__, n=job.fault_count, flow=job.flow,
        )
        if job.fault_count > self.retries and not job.future.done():
            job.future.set_exception(
                e if isinstance(e, Exception)
                else PintTpuError(f"job quantum failed: {e!r}")
            )

    # -- yield / resume ----------------------------------------------------
    def _preempt_all(self):
        """Yield: checkpoint every running job and mark it PREEMPTED; no
        quantum starts until the pressure clears."""
        for job in self._jobs:
            if job.state != RUNNING:
                continue
            job.state = PREEMPTED
            job.preemptions += 1
            self._checkpoint(job)
            _obs.metrics.counter("serve.jobs.preempted").inc()
            TRACER.event(
                "job-preempt", "jobs", kind=job.kind,
                quanta=job.quanta, flow=job.flow,
            )

    def _resume_all(self):
        for job in self._jobs:
            if job.state != PREEMPTED:
                continue
            job.state = RUNNING
            _obs.metrics.counter("serve.jobs.resumed").inc()
            TRACER.event(
                "job-resume", "jobs", kind=job.kind,
                quanta=job.quanta, flow=job.flow,
            )

    def _checkpoint(self, job):
        """Snapshot the runner — in memory always, atomically to disk
        when the request names a path (a kill mid-write leaves the
        previous checkpoint intact)."""
        try:
            job.checkpoint_payload = job.runner.checkpoint_payload()
            if job.req.checkpoint_path:
                ckpt.save_job(
                    job.req.checkpoint_path, job.checkpoint_payload
                )
                _obs.metrics.counter("serve.jobs.checkpoints").inc()
                TRACER.event(
                    "job-checkpoint", "jobs", kind=job.kind,
                    quanta=job.quanta, flow=job.flow,
                )
        except Exception as e:
            # a failed checkpoint costs durability, not the job
            _obs.metrics.counter("serve.jobs.ckpt_failed").inc()
            TRACER.event(
                "job-checkpoint-failed", "jobs", kind=job.kind,
                error=repr(e), flow=job.flow,
            )

    # -- completion --------------------------------------------------------
    def _finish(self, job):
        from pint_tpu_torch.serve.api import JobResponse

        t_done = time.monotonic()
        job.stages["finish"] = t_done
        try:
            result = job.runner.result()
        except Exception as e:
            if not job.future.done():
                job.future.set_exception(e)
            return
        _obs.metrics.counter("serve.jobs.completed").inc()
        TRACER.event(
            "job-state", "jobs", kind=job.kind, state="DONE",
            quanta=job.quanta, flow=job.flow,
        )
        if not job.future.done():
            job.future.set_result(JobResponse(
                request_id=job.req.request_id,
                kind=job.kind,
                result=result,
                quanta=job.quanta,
                preemptions=job.preemptions,
                resumed=job.resumed,
                ntoa=int(job.session.cm.bundle.ntoa),
                bucket=int(job.session.bucket),
                wall_ms=(t_done - job.t_submit) * 1e3,
                stages=dict(job.stages),
            ))

    # -- programs ----------------------------------------------------------
    def _stream(self, r):
        """The jobs' own CUDA stream on replica ``r``'s device (None on
        the CPU), apart from the replica's dispatch stream."""
        if r.device.type != "cuda":
            return None
        s = self._streams.get(r.tag)
        if s is None:
            s = self._streams[r.tag] = torch.cuda.Stream(r.device)
        return s

    def _kernel_for(self, session, key, cap, r, priors, ledgerable,
                    bundle):
        """The scheduler's program cache view, per (key, capacity,
        replica): power-of-two quanta and sticky homes mean a steady state
        hits this dict and builds nothing.  The program's first call
        builds (and captures) under the session's trace lock and writes
        the warm ledger through when the job is ledgerable.  ``bundle`` is
        a host bundle of the session's structure (the leaf layout)."""
        from pint_tpu_torch.serve import session as smod
        from pint_tpu_torch.serve import warm_ledger as wlmod

        kkey = (key, int(cap), r.tag)
        k = self._kernels.get(kkey)
        if k is not None:
            return k
        inner = jkmod.build_job_kernel(
            session, key, int(cap), r.programs, r.tag, priors=priors,
            bundle=bundle,
        )
        noted = [not ledgerable]

        def ledgered(*args):
            out = inner(*args)
            if not noted[0]:
                noted[0] = True
                wlmod.note_warm(session, key, int(cap), r.tag)
            return out

        k = smod.serialized(ledgered, session.trace_lock,
                            r.device.type == "cuda")
        self._kernels[kkey] = k
        return k

    # -- boot replay (warm ledger) ----------------------------------------
    def prewarm(self, works) -> int:
        """Replay ledgered job programs at boot, BEFORE traffic: each
        (BatchWork, placements) from ``warm_ledger.replay_jobs`` runs one
        synthetic quantum on every live replica (programs are per
        replica, so warming only a home would leave a migrated job one
        build away)."""
        from pint_tpu_torch.serve.batcher import tree_leaves
        from pint_tpu_torch.serve.session import run_fenced

        n = 0
        for work, _placements in works:
            sess, key, cap = work.session, work.key, work.cap
            priors = None
            if key[3] in ("mcmc", "mcmc0"):
                priors = default_priors_for(
                    sess.cm.model, list(sess.cm.free_names)
                )
            host_bundle = work.ops[0]
            for r in self.engine.pool.live:
                try:
                    kern = self._kernel_for(sess, key, cap, r, priors,
                                            True, host_bundle)
                    dev = r.device

                    def launch(kern=kern, dev=dev):
                        ops = [torch.as_tensor(np.ascontiguousarray(a),
                                               device=dev)
                               for a in tree_leaves(work.ops)]
                        if key[3] == "mcmc":
                            # a one-step quantum: the step program's
                            # warm-up and capture
                            return kern(ops[:-2], ops[-2], ops[-1], [0])
                        return kern(*ops)

                    run_fenced(launch, dev, self._stream(r))
                    _obs.metrics.counter("serve.warm.replayed").inc()
                    n += 1
                except Exception as exc:
                    _obs.metrics.counter("serve.warm.failed").inc()
                    TRACER.event(
                        "warm-replay-skip", "serve",
                        cid=sess.cid, kind=str(key[3]),
                        error=repr(exc),
                    )
        return n

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        mc = _obs.metrics.counter

        def pct(q):
            v = self._m_quantum.percentile(q)
            return None if v is None else round(v, 3)

        with self._cond:
            queued = len(self._pending)
        states = [j.state for j in list(self._jobs)]
        return {
            "enabled": self.enabled,
            "running": states.count(RUNNING),
            "preempted_now": states.count(PREEMPTED),
            "queued": queued + states.count(QUEUED),
            "submitted": mc("serve.jobs.submitted").value,
            "completed": mc("serve.jobs.completed").value,
            "rejected": mc("serve.jobs.rejected").value,
            "quanta": mc("serve.jobs.quanta").value,
            "preemptions": mc("serve.jobs.preempted").value,
            "resumes": mc("serve.jobs.resumed").value,
            "checkpoints": mc("serve.jobs.checkpoints").value,
            "restores": mc("serve.jobs.restores").value,
            "faults": mc("serve.jobs.faults").value,
            "kernels": len(self._kernels),
            "quantum_p50_ms": pct(0.50),
            "quantum_p99_ms": pct(0.99),
        }

    def stop(self):
        """Shutdown: checkpoint running jobs and shed everything typed
        (``RequestRejected('shutdown')``) — called by
        ``TimingEngine.close`` BEFORE the pool drains, so no quantum is in
        flight while replicas drain.  The scheduler thread's join is
        bounded."""
        with self._cond:
            self._stop = True
            pend = list(self._pending)
            self._pending.clear()
            t = self._thread
            self._cond.notify_all()
        if t is not None:
            t.join(120.0)
        for req, fut in pend:
            if not fut.done():
                fut.set_exception(RequestRejected(
                    "shutdown", "engine is closed"
                ))
        for job in self._jobs:
            if job.future.done():
                continue
            self._checkpoint(job)
            job.future.set_exception(RequestRejected(
                "shutdown",
                "engine closed with the job incomplete"
                + (
                    f" (checkpointed at {job.req.checkpoint_path})"
                    if job.req.checkpoint_path else ""
                ),
            ))
