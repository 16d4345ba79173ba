"""ObserveSession: the O(append) streaming-timing serving surface.

Counterpart of ``pint_tpu/serve/stream.py``.  An observatory pipeline
watches one pulsar for months: every few minutes a handful of new TOAs
arrive and the operator wants the refreshed timing solution (and residual
alerts) at O(new data) cost, not O(entire history).

A stream owns three layers of state:

- **TOA layer**: the absorbed TOA set, extended per append.  A port
  ``TOAs`` merges through ``toas/cache.py::append_ingested`` (only the
  tail is ingested); a host TOA table merges row-wise
  (:func:`merge_tables`), time-sorted like ``merge_TOAs``, its noise-basis
  columns recomputed over the merged set.
- **Solver layer**: the additive Gram-block state of
  ``fitting/gls.py::stream_state_*`` (normal equations, Woodbury blocks,
  the maintained equilibrated Sigma Cholesky factor advanced by
  ``ops/cholupdate.py``), held on the HOST as numpy between appends:
  each append ships a copy to the card as the batch's input and the
  stream commits only from a fenced, validated output, so a failed
  append batch leaves it as it was — plus the FROZEN Fourier anchor
  (freqs, day0) appended basis rows evaluate at
  (``models/noise.py::fourier_basis_rows``).
- **Serving layer**: appends ride the same replica fabric as every
  other request — an :class:`~pint_tpu_torch.serve.api.AppendRequest`
  batched under key ``("append", composition, tail bucket, mode)``, so
  concurrent streams of one composition stack into one batched dispatch
  and a steady state builds and captures nothing (tail buckets are
  powers of two: a build happens only at a bucket's first append).

Fallback chain (every rung resolves the SAME caller future, typed; every
rung runs on the serving device — none carries on on the CPU):

1. **incremental** — the O(append) rank-update program.  Eligible
   compositions only (``serve/session.py::stream_fast_path``: white or a
   single pure-Fourier achromatic basis); the in-program drift guard
   (``PINT_TPU_TORCH_STREAM_DRIFT_RTOL``, the NaN-poison residual check)
   rolls the state back and fails ONLY that stream's row.
2. **warm** — a full refit warm-started from the stream's solution
   (``FitRequest(x0=...)``, an input of the already built fit program),
   which also re-anchors the solver state (the periodic refresh: every
   ``PINT_TPU_STREAM_REFRESH`` appends the append itself takes this
   rung).  Ineligible compositions (ECORR, chromatic bases) serve every
   append here.
3. **cold** — a from-scratch fit (x0 = the par file's model).
4. a typed exception on the caller's future.  Never a hang, never a
   silent wrong answer.

Appends on one stream are SERIALIZED (the solver state is a chain);
continuations run on the engine's stream executor, off the replicas'
fence threads.  Residual alerts: each append's chi2 increment is scored
against its chi2_k expectation; anomalies land in
``AppendResponse.alerts`` and ``serve.stream.alerts``.  Every wait a
stream makes is bounded (``STREAM_TIMEOUT_S``).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import Future

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError, RequestRejected
from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import lockwitness
from pint_tpu_torch.runtime.guard import validate_finite
from pint_tpu_torch.serve import session as smod
from pint_tpu_torch.serve.api import (
    PRIORITY_NORMAL,
    AppendRequest,
    AppendResponse,
    FitRequest,
)

#: default appends between full re-anchors of the solver state
DEFAULT_REFRESH = 64

#: default chi2-increment tail probability below which an append raises a
#: residual alert (scored against chi2_k, k = appended rows)
DEFAULT_ALERT_P = 1e-3

#: the bound of every wait of a stream (its opening fit)
STREAM_TIMEOUT_S = 1800.0


def stream_refresh() -> int:
    """PINT_TPU_STREAM_REFRESH: appends between full re-anchors (the
    linearized r-advance drifts at second order; the drift guard catches
    decay, the refresh bounds it by construction)."""
    return int(os.environ.get("PINT_TPU_STREAM_REFRESH",
                              str(DEFAULT_REFRESH)))


def _chi2_tail_p(dchi2: float, k: int) -> float:
    """P(chi2_k >= dchi2) — the residual-alert score: each appended
    whitened residual contributes ~chi2_1 under the current model."""
    from scipy.stats import chi2 as chi2_dist

    return float(chi2_dist.sf(max(float(dchi2), 0.0), max(int(k), 1)))


def _noise_basis_keys(model) -> set:
    """The mask columns of the model's noise bases (Fourier bases, ECORR
    quantization): functions of the whole TOA set, recomputed for a
    merged set rather than concatenated."""
    keys = set()
    for c in model.noise_components:
        if hasattr(c, "basis_keys"):
            keys.update(c.basis_keys())
    return keys


def merge_tables(model, tables) -> dict:
    """Host TOA tables concatenated row-wise and time-sorted (the
    ``merge_TOAs`` order): every per-TOA column, flag and precomputed mask
    column joined, the model's noise-basis columns dropped so that they
    are recomputed over the merged set, the first table's TZR row kept."""
    from pint_tpu_torch.toas.bundle import take_rows

    t0 = tables[0]
    n = [len(t["freq_mhz"]) for t in tables]
    drop = _noise_basis_keys(model)
    out = {}
    for key, v in t0.items():
        if key == "tzr":
            out[key] = v
        elif key in ("flags", "obs"):
            out[key] = (None if v is None
                        else sum((list(t[key]) for t in tables), []))
        elif key in ("obs_planet_pos_ls", "masks"):
            if v is None:
                out[key] = None
                continue
            out[key] = {
                k: np.concatenate([np.asarray(t[key][k]) for t in tables])
                for k in v if k not in drop
            }
        elif isinstance(v, np.ndarray) and v.shape[:1] == (n[0],):
            out[key] = np.concatenate([np.asarray(t[key]) for t in tables])
        else:
            out[key] = v
    day = np.asarray(out["tdb_day"], np.float64)
    sec = (np.asarray(out["tdb_sec_hi"], np.float64)
           + np.asarray(out["tdb_sec_lo"], np.float64))
    order = np.lexsort((sec, day))
    return take_rows(out, order)


def _ntoa(toas) -> int:
    return len(toas) if not isinstance(toas, dict) else len(
        toas["freq_mhz"])


class ObserveSession:
    """One long-lived streaming timing session (built by
    ``TimingEngine.open_stream``, which owns the stream cap)."""

    def __init__(self, engine, par, toas, *, maxiter: int = 4,
                 refresh: int | None = None,
                 alert_p: float | None = None):
        self.engine = engine
        self._rec = engine.sessions.record_for(par)
        self._maxiter = int(maxiter)
        self._refresh = (
            stream_refresh() if refresh is None else int(refresh)
        )
        self._alert_p = (
            DEFAULT_ALERT_P if alert_p is None else float(alert_p)
        )
        self._lock = lockwitness.wrap(
            threading.Lock(), "ObserveSession._lock"
        )
        self._pending: deque = deque()
        self._busy = False
        self._closed = False
        self._state = None  # host solver state (numpy leaves)
        self._freqs = np.zeros(0)
        self._day0 = 0.0
        self._since_refresh = 0
        if not isinstance(toas, dict):
            toas = self._ingested(toas)
        with TRACER.span("stream:open", "serve", ntoa=_ntoa(toas)):
            # rung 3 exactly: the from-scratch anchor fit
            resp = engine.submit(FitRequest(
                par=self._rec.par, toas=toas, maxiter=self._maxiter,
            )).result(timeout=STREAM_TIMEOUT_S)
            self._commit_fit(resp, toas)
            self._rebuild_state()

    def _ingested(self, toas):
        from pint_tpu_torch.toas.ingest import ingest_for_model

        if toas.t_tdb is None:
            ingest_for_model(toas, self._rec.model)
        return toas

    # -- the public surface ------------------------------------------------
    def append(self, tail, *, deadline_s=None,
               priority=PRIORITY_NORMAL) -> Future:
        """Absorb newly observed TOAs (a host table, or a port ``TOAs``
        like the stream's); returns a Future resolving to an
        :class:`AppendResponse` (or raising typed).  Appends on one stream
        serialize in submission order — the solver state is a chain;
        concurrency comes from batching ACROSS streams."""
        outer: Future = Future()
        with TRACER.span(
            "stream:append", "serve", ntoa=_ntoa(tail),
            absorbed=self._ntoa,
        ):
            obs_metrics.counter("serve.stream.appends").inc()
            with self._lock:
                if self._closed:
                    raise RequestRejected(
                        "stream-closed", "ObserveSession is closed"
                    )
                self._pending.append(
                    (tail, outer, deadline_s, priority)
                )
                launch = not self._busy
                if launch:
                    self._busy = True
            if launch:
                self.engine._stream_executor().submit(self._advance)
        return outer

    def close(self):
        with self._lock:
            self._closed = True
        self.engine._close_stream(self)

    @property
    def ntoa(self) -> int:
        return self._ntoa

    @property
    def deltas(self) -> np.ndarray:
        return np.array(self._x)

    @property
    def uncertainties(self) -> np.ndarray:
        return np.array(self._unc)

    @property
    def chi2(self) -> float:
        return self._chi2

    @property
    def names(self) -> tuple:
        return tuple(self._names)

    def fitted_par(self) -> str:
        """Par-file text with the stream's current solution committed
        (the stream's own record, never the session prototype)."""
        return self._rec.commit_clone(
            self._names, self._x, self._unc
        ).as_parfile()

    # -- serialized append machinery (stream-executor threads) -------------
    def _advance(self):
        while True:
            with self._lock:
                if not self._pending:
                    self._busy = False
                    return
                tail, outer, deadline_s, priority = self._pending.popleft()
            try:
                self._serve_one(tail, outer, deadline_s, priority)
                return  # the continuation advances the chain
            except Exception as e:
                if not outer.done():
                    outer.set_exception(e)

    def _merged(self, tail):
        """The absorbed set with ``tail`` appended."""
        if isinstance(self._toas, dict):
            return merge_tables(self._rec.model, [self._toas, tail])
        from pint_tpu_torch.toas.cache import append_ingested

        return append_ingested(self._toas, tail, self._rec.model)

    def _serve_one(self, tail, outer, deadline_s, priority):
        incremental = (
            self._state is not None
            and self._since_refresh < self._refresh
        )
        if not incremental:
            # the periodic refresh rides the warm rung: the refit's state
            # rebuild IS the re-anchor
            self._warm_refit(tail, outer, deadline_s, priority,
                             rung="warm")
            return
        req = AppendRequest(
            par=self._rec.par, toas=tail, state=self._state,
            freqs=self._freqs, day0=self._day0,
            ntoa_prev=self._ntoa, deadline_s=deadline_s,
            priority=priority,
        )
        fut = self.engine.submit(req)
        fut.add_done_callback(
            lambda f: self.engine._stream_executor().submit(
                self._on_incremental, f, tail, outer,
                deadline_s, priority,
            )
        )

    def _on_incremental(self, fut, tail, outer, deadline_s, priority):
        try:
            resp = fut.result()
        except Exception as e:
            # drift poison, replica fault, shed — every failure class
            # fails over to the warm rung; the refit re-anchors, so a
            # drifted state never serves twice
            obs_metrics.counter("serve.stream.drift_fallback").inc()
            TRACER.event(
                "stream-fallback", "serve", rung="warm",
                error=type(e).__name__,
            )
            try:
                self._warm_refit(tail, outer, deadline_s, priority,
                                 rung="warm")
            except Exception as e2:
                if not outer.done():
                    outer.set_exception(e2)
                self._advance()
            return
        try:
            merged = self._merged(tail)
            alerts = self._score_alerts(resp.chi2, _ntoa(tail),
                                        resp.refit)
            self._toas = merged
            self._ntoa = _ntoa(merged)
            self._state = resp.state
            self._x = np.asarray(resp.state["x"])
            self._unc = np.asarray(resp.uncertainties)
            self._chi2 = float(resp.chi2)
            self._since_refresh += 1
            resp.ntoa = self._ntoa
            resp.alerts = alerts
            resp.state = None  # engine-internal, never caller-facing
            obs_metrics.counter("serve.stream.incremental").inc()
            outer.set_result(resp)
        except Exception as e:
            if not outer.done():
                outer.set_exception(e)
        self._advance()

    def _warm_refit(self, tail, outer, deadline_s, priority, *,
                    rung: str):
        """Rungs 2 and 3: a full refit over the merged set, warm-started
        from the stream's solution on 'warm' (x0 is an input of the
        already built fit program), from the par file's model on
        'cold'."""
        merged = self._merged(tail)
        req = FitRequest(
            par=self._rec.par, toas=merged,
            x0=(np.array(self._x) if rung == "warm" else None),
            maxiter=self._maxiter, deadline_s=deadline_s,
            priority=priority,
        )
        fut = self.engine.submit(req)
        fut.add_done_callback(
            lambda f: self.engine._stream_executor().submit(
                self._on_refit, f, merged, tail, outer,
                deadline_s, priority, rung,
            )
        )

    def _on_refit(self, fut, merged, tail, outer, deadline_s,
                  priority, rung):
        try:
            resp = fut.result()
        except Exception as e:
            if rung == "warm":
                obs_metrics.counter("serve.stream.cold_fallback").inc()
                TRACER.event(
                    "stream-fallback", "serve", rung="cold",
                    error=type(e).__name__,
                )
                try:
                    self._warm_refit(tail, outer, deadline_s,
                                     priority, rung="cold")
                except Exception as e2:
                    if not outer.done():
                        outer.set_exception(e2)
                    self._advance()
            else:
                if not outer.done():
                    outer.set_exception(e)
                self._advance()
            return
        try:
            alerts = self._score_alerts(resp.chi2, _ntoa(tail), rung)
            self._commit_fit(resp, merged)
            self._rebuild_state()
            obs_metrics.counter(f"serve.stream.{rung}_refit").inc()
            outer.set_result(AppendResponse(
                request_id=resp.request_id, ntoa=self._ntoa,
                appended=_ntoa(tail), names=resp.names,
                deltas=resp.deltas,
                uncertainties=resp.uncertainties, chi2=resp.chi2,
                converged=resp.converged, refit=rung, alerts=alerts,
                bucket=resp.bucket, batch_size=resp.batch_size,
                wall_ms=resp.wall_ms, replica=resp.replica,
                stages=resp.stages,  # the serving fit's stage vector
            ))
        except Exception as e:
            if not outer.done():
                outer.set_exception(e)
        self._advance()

    # -- state anchoring ---------------------------------------------------
    def _commit_fit(self, resp, toas):
        self._toas = toas
        self._ntoa = _ntoa(toas)
        self._names = tuple(resp.names)
        self._x = np.asarray(resp.deltas, dtype=np.float64)
        self._unc = np.asarray(resp.uncertainties)
        self._chi2 = float(resp.chi2)

    def _score_alerts(self, chi2_new, k: int, rung: str) -> tuple:
        """chi2-increment anomaly score: under the current model the k
        appended whitened residuals add ~chi2_k; a tail probability below
        ``alert_p`` flags a timing anomaly (glitch, profile change,
        instrumental).  Refit rungs may DECREASE chi2 (the solution
        moved); only the increment is scored."""
        dchi2 = float(chi2_new) - self._chi2
        p = _chi2_tail_p(dchi2, k)
        if p >= self._alert_p:
            return ()
        obs_metrics.counter("serve.stream.alerts").inc()
        TRACER.event(
            "stream-alert", "serve", dchi2=round(dchi2, 3), k=k,
            p=float(p), rung=rung,
        )
        return (
            f"chi2-jump: +{dchi2:.3f} over {k} appended TOAs "
            f"(P[chi2_{k} >= dchi2] = {p:.2e} < {self._alert_p:g})",
        )

    def _rebuild_state(self):
        """(Re)build the solver state from the whole absorbed set — the
        stream's open and every refresh.  O(n), rare by design; the init
        program is cached per full-set (composition, bucket) in the
        engine's stream program cache, so a re-anchor at an unchanged
        bucket replays and a build happens only at bucket promotion."""
        # a failed rebuild leaves the stream WARM-ONLY, never a stale
        # state that excludes committed TOAs
        self._state = None
        eng = self.engine
        rec = self._rec
        table = smod.request_table(self._toas, rec.model)
        cpu, host = smod.request_bundles(rec.model, table)
        sess = eng.sessions.session_for(rec, table, cpu, eng.min_bucket)
        if smod.stream_fast_path(sess.cm) is None:
            # no incremental path for this composition: every append
            # takes the warm rung (still batched, still build-free)
            return
        with TRACER.span(
            "stream:refresh", "serve", ntoa=self._ntoa,
            bucket=sess.bucket,
        ):
            obs_metrics.counter("serve.stream.refresh").inc()
            ops = smod.stream_init_operands(
                sess, host, rec.refnum, self._x, self._ntoa)
            out = eng._stream_init(sess, ops)
            state = {k: np.asarray(v) for k, v in out.items()}
            validate_finite(
                {f"state.{k}": v for k, v in state.items()},
                site="serve:stream-init",
                what="streaming state rebuild",
            )
            self._state = state
            self._freqs, self._day0 = self._frozen_anchor(sess, table)
            self._since_refresh = 0

    def _frozen_anchor(self, sess, table):
        """The frozen Fourier layout appended rows evaluate at: the host
        IEEE twin of ``models/noise.py::fourier_freqs`` over the CURRENT
        absorbed set (``host_fourier_basis``'s convention, which
        precomputed the init basis in the bundle's masks)."""
        if smod.stream_fast_path(sess.cm) != "fourier":
            return np.zeros(0), 0.0
        (kcols,), _ = smod._basis_struct(sess.cm)
        nharm = kcols // 2
        day = np.asarray(table["tdb_day"], dtype=np.float64)
        sec = (np.asarray(table["tdb_sec_hi"], np.float64)
               + np.asarray(table["tdb_sec_lo"], np.float64))
        t = (day - day[0]) * 86400.0 + sec
        tspan = t.max() - t.min()
        if not tspan > 0:
            raise PintTpuError(
                "streaming Fourier anchor needs a nonzero TOA span"
            )
        freqs = np.arange(1, nharm + 1, dtype=np.float64) / tspan
        return freqs, float(day[0])


def append_aux(p) -> dict:
    """One stream's aux operand for the batched append program
    (``serve/session.py::_append_run``): its solver state, live tail
    count and frozen basis anchor, all composition-static shapes."""
    req = p.req
    return {
        "state": {k: np.asarray(v) for k, v in req.state.items()},
        "nlive": np.int64(p.ntoa),
        "freqs": np.asarray(
            req.freqs if req.freqs is not None else [], dtype=np.float64,
        ),
        "day0": np.float64(req.day0),
    }

