"""Warm-restart ledger: the serving fabric's warm surface, kept on disk.

Counterpart of ``pint_tpu/serve/warm_ledger.py``.  A restarted engine
would otherwise re-discover its warm surface from live traffic: which
compositions, buckets, capacities and job kinds were serving.  Until the
traffic mix came back, every first-of-kind batch would pay a program
build and, on the card, a capture in the latency path.  The ledger keeps
that surface on disk and replays it at boot:

- **write-through** happens where a serve program is first called (built
  and, on the card, captured): the replica's program wrapper
  (``serve/fabric/replica.py::Replica._kernel_for``) and the job
  scheduler's call :func:`note_warm` with (session, group key, capacity,
  replica tag), and every registered ledger records it — the ledger is
  exactly the set of programs the fleet built, never a guess.
- **entries** are JSON (``{"version": LEDGER_VERSION, "entries":
  {...}}``): per (composition, op, bucket, op parameters) the founder's
  par TEXT (the replay re-parses it, so the composition key recomputes
  identically), the capacities built and the placement classes.  A
  pickle *sidecar* per (composition, bucket) keeps the PADDED prototype
  bundle as host numpy arrays (its TZR row included), never card
  tensors, so a session rebuilds at boot with no TOA table, no ingest
  environment and no TZR ingest (``Session.from_prototype``).
- **replay** (:func:`replay_jobs` + ``ReplicaPool.prewarm`` and
  ``JobScheduler.prewarm``) rebuilds each session, installs it in the
  SessionCache, and runs one synthetic batch per (key, capacity) through
  every replica — the normal guarded path — before the engine's
  collector starts.

What a restart keeps differs from the reference: XLA executables
persist in its compile cache, CUDA graphs do not persist.  So the port's
restart contract is that the replay rebuilds and captures every ledgered
(key, capacity) before the collector opens, after which the same traffic
builds and captures nothing, and ``ops/_cuda_build.py`` builds no kernel
(its libraries are named after their sources' hash and are found on
disk).

The port's ledger has a version tag and a default path of its own, so
that neither package loads the other's ledger or sidecars (as the port's
ingest cache never loads the reference's file).  A corrupt, truncated or
version-stale ledger or sidecar degrades to a clean COLD boot:
``serve.warm.stale`` / ``serve.warm.failed`` count it, nothing raises
into the engine.  Enablement is explicit: ``$PINT_TPU_SERVE_WARM_LEDGER``
or ``TimingEngine(warm_ledger=)`` — ``0``/``off`` disables, ``1``/``on``
takes the default path, anything else is the ledger's path.  The sidecar
is pickle in the user's own cache directory; load only files this
program wrote.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from collections import OrderedDict

import numpy as np

from pint_tpu_torch import obs as _obs
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.runtime import lockwitness

#: the port's own schema tag (the reference writes the integer 1): a
#: ledger or sidecar with any other tag is IGNORED (clean cold boot)
LEDGER_VERSION = "pint_tpu_torch-warm-1"

#: ledger entries kept (LRU by last warm): bounds the JSON rewrite and
#: the boot replay
MAX_ENTRIES = 64

#: the default ledger's file name, in the port's cache directory
DEFAULT_NAME = "serve-warm-ledger-torch.json"


def default_dir() -> str:
    """``$PINT_TPU_CACHE_DIR`` (the port's ingest cache directory) when
    set, else ``~/.cache/pint_tpu_torch``."""
    d = os.environ.get("PINT_TPU_CACHE_DIR", "").strip()
    return d or os.path.join(os.path.expanduser("~"), ".cache",
                             "pint_tpu_torch")


def ledger_path(override=None) -> str | None:
    """The active warm-ledger path, or None when disabled.

    ``override`` (the engine keyword) beats ``$PINT_TPU_SERVE_WARM_
    LEDGER``: False/'0'/'off' disable, True/'1'/'on' take the default
    path (:func:`default_dir`), any other string is the path itself."""
    if override is False:
        return None
    if override is None or override is True:
        raw = os.environ.get("PINT_TPU_SERVE_WARM_LEDGER", "")
        if override is True and not raw.strip():
            raw = "1"
    else:
        raw = str(override)
    raw = raw.strip()
    if raw.lower() in ("", "0", "off", "no", "false"):
        return None
    if raw.lower() in ("1", "on", "yes", "true"):
        return os.path.join(default_dir(), DEFAULT_NAME)
    return raw


def host_bundle(bundle):
    """A device TOABundle as host numpy arrays (its TZR row too)."""
    from pint_tpu_torch.serve.batcher import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), bundle)


def device_bundle(bundle, device):
    """A host-numpy TOABundle as tensors on ``device``."""
    import torch

    from pint_tpu_torch.serve.batcher import tree_map

    return tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device),
                    bundle)


class WarmLedger:
    """One on-disk warm-state ledger (JSON index + pickle sidecars).

    Thread-safe: ``record`` is called from whichever serving thread
    builds a program first, ``load``/``load_sidecar`` from the boot
    thread.  Writes are atomic (tmp + rename) and happen only at first
    builds, which are rare by the no-steady-build invariant."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = lockwitness.wrap(
            threading.Lock(), "WarmLedger._lock"
        )
        self._entries: OrderedDict | None = None

    # -- read side ---------------------------------------------------------
    def load(self) -> list:
        """The ledger's entries (copies), [] on any corruption or version
        mismatch — a bad ledger is a clean cold boot."""
        with self._lock:
            return [dict(e) for e in self._load_locked().values()]

    def _load_locked(self) -> OrderedDict:
        if self._entries is not None:
            return self._entries
        entries: OrderedDict = OrderedDict()
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if doc.get("version") != LEDGER_VERSION:
                raise ValueError(
                    f"ledger version {doc.get('version')!r} != "
                    f"{LEDGER_VERSION!r}"
                )
            for eid, e in doc["entries"].items():
                if not (isinstance(e, dict) and "par" in e
                        and "op" in e and "bucket" in e):
                    raise ValueError(f"malformed entry {eid!r}")
                entries[eid] = e
        except FileNotFoundError:
            pass
        except Exception as exc:
            entries = OrderedDict()
            _obs.metrics.counter("serve.warm.stale").inc()
            TRACER.event(
                "warm-ledger-stale", "serve", path=self.path,
                error=repr(exc),
            )
        self._entries = entries
        return entries

    def load_sidecar(self, entry: dict):
        """The padded prototype bundle (host numpy, TZR row inside) of one
        entry; raises on a missing, corrupt or stale sidecar (the replay
        skips the entry)."""
        p = os.path.join(
            os.path.dirname(self.path) or ".", entry["sidecar"]
        )
        with open(p, "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) or \
                payload.get("version") != LEDGER_VERSION:
            raise PintTpuError(
                f"warm sidecar {entry['sidecar']!r} is not a "
                f"{LEDGER_VERSION!r} sidecar"
            )
        return payload["bundle"]

    # -- write side --------------------------------------------------------
    def record(self, session, key: tuple, cap: int, tag: str):
        """Write-through one built program: merge (composition, op,
        bucket, op parameters) x (capacity, placement class) into the
        ledger and persist."""
        op = key[0]
        bucket = int(key[2])
        if op == "fit":
            params = {
                "mode": str(key[3]), "maxiter": int(key[4]),
                "tol": float(key[5]),
            }
        elif op == "residuals":
            params = {"subtract_mean": bool(key[3])}
        elif op == "job":
            # background-class programs: the kind slot key[3] decides
            # the parameters.  MCMC entries are recorded only for
            # founder-par default-prior programs (the scheduler marks
            # those ledgerable), whose priors a replay can rebuild
            kind = str(key[3])
            if kind == "grid":
                params = {
                    "kind": kind, "names": list(key[4]),
                    "refit": bool(key[5]), "iters": int(key[6]),
                }
            elif kind == "mcmc":
                params = {
                    "kind": kind, "nwalkers": int(key[4]),
                    "a": float(key[5]), "prior": str(key[6]),
                }
            elif kind == "mcmc0":
                params = {
                    "kind": kind, "nwalkers": int(key[4]),
                    "prior": str(key[5]),
                }
            elif kind == "nested":
                params = {"kind": kind}
            else:
                return
        else:
            return
        placement = "gang" if str(tag).startswith("g") else "single"
        eid = f"{session.cid}:{op}:{bucket}:" + ":".join(
            f"{k}={v}" for k, v in sorted(params.items())
        )
        with self._lock:
            entries = self._load_locked()
            e = entries.get(eid)
            changed = e is None
            if e is None:
                e = entries[eid] = {
                    "cid": session.cid, "op": op, "bucket": bucket,
                    "par": session.founder_par, "params": params,
                    "caps": [], "placements": [],
                    "sidecar": f"warm-torch-{session.cid}-{bucket}.pkl",
                }
            if int(cap) not in e["caps"]:
                e["caps"] = sorted(set(e["caps"]) | {int(cap)})
                changed = True
            if placement not in e["placements"]:
                e["placements"] = sorted(
                    set(e["placements"]) | {placement}
                )
                changed = True
            entries.move_to_end(eid)
            while len(entries) > MAX_ENTRIES:
                entries.popitem(last=False)
                changed = True
            if changed:
                self._write_sidecar_locked(e["sidecar"], session)
                self._save_locked()
        if changed:
            _obs.metrics.counter("serve.warm.recorded").inc()

    def _write_sidecar_locked(self, name: str, session):
        p = os.path.join(os.path.dirname(self.path) or ".", name)
        if os.path.exists(p):
            return
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        payload = {
            "version": LEDGER_VERSION,
            "bundle": host_bundle(session.cm.bundle),
        }
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, p)

    def _save_locked(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        doc = {"version": LEDGER_VERSION, "entries": dict(self._entries)}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self.path)


# -- write-through registration -------------------------------------------
_alock = lockwitness.wrap(threading.Lock(), "warm_ledger._alock")
_active: list = []


def register(ledger: WarmLedger):
    with _alock:
        _active.append(ledger)


def unregister(ledger: WarmLedger):
    with _alock:
        if ledger in _active:
            _active.remove(ledger)


def note_warm(session, key: tuple, cap: int, tag: str):
    """The write-through hook, called at each serve program's first call.
    Never raises: a ledger write failure costs warm state, not a
    dispatch (``serve.warm.failed``)."""
    if not _active:
        return
    with _alock:
        leds = list(_active)
    for led in leds:
        try:
            led.record(session, key, cap, tag)
        except Exception as exc:
            _obs.metrics.counter("serve.warm.failed").inc()
            TRACER.event(
                "warm-record-failed", "serve", error=repr(exc)
            )


# -- boot-time replay ------------------------------------------------------
def _job_key(sess, params) -> tuple:
    kind = str(params["kind"])
    if kind == "grid":
        return ("job", sess.composition, sess.bucket, "grid",
                tuple(params["names"]), bool(params["refit"]),
                int(params["iters"]))
    if kind == "mcmc":
        return ("job", sess.composition, sess.bucket, "mcmc",
                int(params["nwalkers"]), float(params["a"]),
                str(params["prior"]))
    if kind == "mcmc0":
        return ("job", sess.composition, sess.bucket, "mcmc0",
                int(params["nwalkers"]), str(params["prior"]))
    return ("job", sess.composition, sess.bucket, "nested")


def replay_jobs(ledger: WarmLedger, sessions, max_batch=None) -> list:
    """Every ledger entry as pre-warm work: a list of (BatchWork,
    placement classes) with no live members and synthetic stacked
    operands (the padded prototype bundle repeated to each recorded
    capacity — the shapes and dtypes live traffic stacks).  Each entry
    rebuilds its session (:meth:`Session.from_prototype`) and installs it
    in the SessionCache, so the first real request of the composition is
    a session hit.  Job entries carry the job program's own synthetic
    operands (``serve/jobs/kernels.py::synthetic_operands``).  A failing
    entry is skipped (``serve.warm.failed``): the replay is best-effort
    by design."""
    from pint_tpu_torch.serve import batcher as bmod
    from pint_tpu_torch.serve import session as smod
    from pint_tpu_torch.serve.fabric import BatchWork
    from pint_tpu_torch.serve.jobs import kernels as jkmod

    cap_ceiling = (
        None if max_batch is None
        else bmod.capacity_for(int(max_batch), int(max_batch))
    )
    device = sessions.device
    jobs = []
    for e in ledger.load():
        try:
            rec = sessions.record_for(e["par"])
            hb = ledger.load_sidecar(e)
            cm = rec.model.compile(device_bundle(hb, device))
            comp = smod.composition_key(
                cm, rec.layout, rec.static_ref, rec.par_hash,
                rec.model.tzr_anchor is not None,
            )
            sess = sessions.install(smod.Session.from_prototype(
                rec, cm, int(e["bucket"]), comp
            ))
            params = e["params"]
            placements = tuple(e.get("placements") or ("single",))
            host = smod._sorted_dicts(hb._replace(tzr=None))
            if e["op"] == "job":
                key = _job_key(sess, params)
                for cap in e["caps"]:
                    ops = jkmod.synthetic_operands(sess, key, int(cap),
                                                   host, rec.refnum)
                    jobs.append((BatchWork(key, [], ops, sess, int(cap)),
                                 placements))
                continue
            if e["op"] == "fit":
                key = (
                    "fit", sess.composition, sess.bucket, sess.mode,
                    int(params["maxiter"]), float(params["tol"]),
                )
            else:
                key = (
                    "residuals", sess.composition, sess.bucket,
                    bool(params["subtract_mean"]),
                )
            for cap in e["caps"]:
                cap = int(cap)
                if cap_ceiling is not None and cap > cap_ceiling:
                    continue
                bstack = bmod.stack_trees([host] * cap)
                rstack = bmod.stack_trees([rec.refnum] * cap)
                xs = np.zeros((cap, sess.cm.nfree))
                jobs.append((
                    BatchWork(key, [], (bstack, rstack, xs), sess, cap),
                    placements,
                ))
        except Exception as exc:
            _obs.metrics.counter("serve.warm.failed").inc()
            TRACER.event(
                "warm-replay-skip", "serve", cid=e.get("cid", "?"),
                error=repr(exc),
            )
    return jobs
