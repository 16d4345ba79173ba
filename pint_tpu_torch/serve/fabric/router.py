"""Affinity router: session-group placement + load-aware routing.

Counterpart of ``pint_tpu/serve/fabric/router.py`` over a pool of
single replicas.  Placement is
keyed by the batcher's GROUP key (operation, composition key, shape
bucket, op parameters) — the exact identity of a step program —
NEVER by a par hash: sessions themselves are composition-keyed
(serve/session.py), so a brand-new par of a known
composition routes to the group's sticky replica and rides its
existing programs with ZERO fresh builds — a whole population
of distinct pars stays one affinity group (the steady-state
invariants tests/test_serve.py and tests/test_serve_population.py
gate).

Policy (the continuous-batching-server shape — per-replica queues fed
by a load-aware router):

- a group's first batch is PLACED on the least-loaded live replica
  and sticks there (cold groups stay on one device — one program per
  kernel shape, total);
- a batch routes to the least-outstanding-work replica among the
  group's placed LIVE replicas (DEGRADED only when no LIVE peer
  holds the group), with round-robin rotation among ties;
- when every placed candidate is SATURATED (outstanding batches
  exceed its inflight bound — work is queuing, not flowing) and the
  affinity cap allows, the group SPILLS to one more live replica
  (hot groups replicate across the pool; each spill costs that
  replica one program build per kernel shape, amortized forever after);
- quarantined/draining replicas are never candidates, and a batch's
  ``excluded`` set (replicas that already failed it) is honored, so
  re-routes are bounded by the pool width.

Fusion colocation: the replica's cross-key fuser
(``replica.py::Replica._fuse``) can only merge batches queued on the SAME
replica, so while ``PINT_TPU_SERVE_XKEY_FUSE`` is on, a small group's
(bucket at or below ``PINT_TPU_SERVE_XKEY_THRESHOLD``) COLD placement
prefers the usable replica already holding the most other small-group
placements (ties by load, then rid): distinct small compositions pile
onto one replica and co-resident batches of different keys become
fusible.  Spill under saturation is unchanged.  Loads count the job
scheduler's in-flight background quanta (``Replica.background``), so
interactive placement steers away from a replica running one.

Not ported with this router: the reference's gang classification (big
groups on gang executors) and the demand signals, placement purge and
epoch of its elastic repartitioner — ROADMAP A12d, with ``gang.py`` and
``elastic.py``.
"""

from __future__ import annotations

import os
import threading

from pint_tpu_torch.obs import metrics as obs_metrics
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import lockwitness
from pint_tpu_torch.serve.fabric.replica import DEGRADED, LIVE


def _load(r) -> float:
    """A replica's load: its outstanding batches plus the background
    quanta it is running (tolerant of test doubles without the term)."""
    return r.outstanding + getattr(r, "background", 0)


def _saturated(r) -> bool:
    """Work is queuing, not flowing: outstanding past the replica's
    inflight bound."""
    return r.outstanding > r.inflight


class Router:
    """Places session groups on replicas and routes assembled batches."""

    def __init__(self, pool, affinity: int | None = None):
        self.pool = pool
        self.affinity = max(
            1, int(affinity) if affinity else pool.size
        )
        self.xkey_fuse = (
            os.environ.get("PINT_TPU_SERVE_XKEY_FUSE", "1") != "0"
        )
        self.xkey_threshold = int(
            os.environ.get("PINT_TPU_SERVE_XKEY_THRESHOLD", "4096")
        )
        self._placements: dict = {}  # group key -> [rid, ...]
        self._rotor: dict = {}  # round-robin counters
        self._lock = lockwitness.wrap(threading.Lock(), "Router._lock")
        self._m_routes = obs_metrics.counter("serve.fabric.routes")
        self._m_spills = obs_metrics.counter("serve.fabric.spills")

    def placement(self, key) -> tuple:
        """The group's current affinity set (observability/tests)."""
        with self._lock:
            return tuple(self._placements.get(key, ()))

    def route(self, work, exclude=()):
        """Pick the serving replica for one assembled batch; None when
        no live/degraded replica can take it (the caller sheds typed).
        Every decision is span-instrumented."""
        with TRACER.span(
            "router:route", "fabric", op=work.key[0],
            n=len(work.live), flow=getattr(work, "flow", None),
        ):
            with self._lock:
                rep = self._route_locked(work.key, set(exclude))
            self._m_routes.inc()
            if rep is not None:
                TRACER.annotate(replica=rep.tag)
                if hasattr(work, "stamp"):
                    work.stamp("route")  # stage clock
            return rep

    def _is_small(self, key) -> bool:
        """Fusion-class work: bucket (key[2]) at or below the cross-key
        fusion cutoff (``Replica._fusible``'s criterion)."""
        try:
            return int(key[2]) <= self.xkey_threshold
        except (IndexError, TypeError, ValueError):
            return False

    def _small_counts_locked(self, key) -> dict:
        """rid -> how many OTHER small groups are placed there (the
        colocation score)."""
        counts: dict = {}
        for k2, rids in self._placements.items():
            if k2 != key and self._is_small(k2):
                for rid in rids:
                    counts[rid] = counts.get(rid, 0) + 1
        return counts

    def _route_locked(self, key, exclude):
        placed = self._placements.setdefault(key, [])
        usable = {
            r.rid: r for r in self.pool.replicas
            if r.state in (LIVE, DEGRADED) and not r.draining
            and r.rid not in exclude
        }
        cands = [usable[rid] for rid in placed if rid in usable]
        # prefer LIVE peers; a DEGRADED replica serves only when no
        # LIVE one holds the group
        live_cands = [r for r in cands if r.state == LIVE]
        if live_cands:
            cands = live_cands
        if (cands and len(placed) < self.affinity
                and all(_saturated(r) for r in cands)):
            # saturated affinity set: spill the group to one more
            # replica (it pays one program build per kernel shape, then
            # serves this group forever)
            fresh = [
                r for r in usable.values() if r.rid not in placed
            ]
            if fresh:
                r = min(fresh, key=lambda r: (_load(r), r.rid))
                placed.append(r.rid)
                cands.append(r)
                self._m_spills.inc()
                TRACER.event(
                    "spill", "fabric", op=key[0], replica=r.tag,
                    width=len(placed),
                )
        if not cands:
            # no placed replica is usable: (re)place on the least-loaded
            # usable replica — except that small groups colocate with
            # other small groups while cross-key fusion is on
            if not usable:
                return None
            if self.xkey_fuse and self._is_small(key):
                small = self._small_counts_locked(key)
                r = min(usable.values(), key=lambda r: (
                    -small.get(r.rid, 0), _load(r), r.rid))
            else:
                r = min(usable.values(), key=lambda r: (_load(r), r.rid))
            if r.rid not in placed:
                placed.append(r.rid)
            return r
        lo = min(_load(r) for r in cands)
        tied = [r for r in cands if _load(r) == lo]
        i = self._rotor.get(key, 0)
        self._rotor[key] = i + 1
        return tied[i % len(tied)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "groups": len(self._placements),
                "placement_widths": sorted(
                    len(v) for v in self._placements.values()
                ),
            }
