"""The port's one-card serving fabric (``pint_tpu_torch/serve/fabric``)
against the reference's, on the CPU.

Port twins of the one-device half of ``tests/test_serve_fabric.py``:
device discovery and env knobs, the router's policy units (sticky
placement, least-outstanding routing, spill on saturation, exclusion,
quarantine avoidance, capacity weighting, size classification), the
health machine and the canary probe, a hang and a NaN pinned to one of
three replicas (quarantine, re-route, re-admission), placement parity of
a 1- and a 4-replica fabric, ``merge_batch_works``, and in-replica
coalescing.  On the CPU the pool's replicas are threads sharing the host
(the reference's tests run on a virtual 8-device mesh).  The fabric's
responses are also held to the JAX engine's on the same pars and TOAs
(one reference subprocess serves the parity stream through a 1-replica
JAX engine and exports the tables and responses).  The cases that need
the card — two replicas on one card, a capture beside another replica's
replays, a wedged kernel seen at the fence — are marked ``gpu``.  Every
wait is bounded.
"""

import collections
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.exceptions import (  # noqa: E402
    GuardTimeout,
    PintTpuError,
    PintTpuNumericsError,
    RequestRejected,
    RetriesExhausted,
)
from pint_tpu_torch.obs import export as obs_export  # noqa: E402
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.obs import trace as obs_trace  # noqa: E402
from pint_tpu_torch.runtime import faults, guard  # noqa: E402
from pint_tpu_torch.serve import (  # noqa: E402
    FitRequest,
    ResidualsRequest,
    TimingEngine,
)
from pint_tpu_torch.serve.fabric import (  # noqa: E402
    DEGRADED,
    DRAINED,
    LIVE,
    QUARANTINED,
    BatchWork,
    FusedBatch,
    Replica,
    ReplicaPool,
    Router,
    merge_batch_works,
    serving_devices,
)

PAR = """
PSR              J0000+00{i:02d}
F0               {f0}  1
F1               -1.1e-15           1
PEPOCH           55000
DM               {dm}             1
"""
PULSARS = [(0, 131.1, 12.0, 40, 21), (1, 177.9, 17.0, 50, 22),
           (2, 95.3, 7.5, 60, 23)]
#: the parity stream: wave-synchronized so every fabric assembles the
#: same batches and only PLACEMENT differs
WAVES = [
    [("residuals", 0), ("residuals", 1), ("residuals", 2)],
    [("fit", 0), ("fit", 1), ("fit", 2)],
    [("residuals", 1)],
    [("fit", 2)],
    [("residuals", 2), ("residuals", 0)],
]

_REF_SCRIPT = """
from pint_tpu.serve import FitRequest, ResidualsRequest, TimingEngine
from pint_tpu.simulation import make_test_pulsar

pulsars = []
for j, (i, f0, dm, n, seed) in enumerate(PULSARS):
    m, t = make_test_pulsar(PAR.format(i=i, f0=f0, dm=dm), ntoa=n,
                            seed=seed, iterations=1)
    export_state(m.compile(t), f"p{j}")
    pulsars.append((m.as_parfile(), t))
META["pars"] = [p for p, _ in pulsars]
out = []
with TimingEngine(max_batch=4, max_wait_ms=100.0, inflight=1,
                  max_queue=128, replicas=1) as eng:
    for wave in WAVES:
        futs = []
        for op, i in wave:
            par, toas = pulsars[i]
            req = (ResidualsRequest(par=par, toas=toas)
                   if op == "residuals"
                   else FitRequest(par=par, toas=toas, maxiter=2))
            futs.append(eng.submit(req))
        out.extend(f.result(timeout=300) for f in futs)
for k, r in enumerate(out):
    OUT[f"s{k}/chi2"] = np.array(r.chi2)
    OUT[f"s{k}/batch"] = np.array(r.batch_size)
    if hasattr(r, "residuals_s"):
        OUT[f"s{k}/res"] = r.residuals_s
    else:
        OUT[f"s{k}/deltas"] = r.deltas
        OUT[f"s{k}/unc"] = r.uncertainties
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_serve_fabric")
    script = (f"PAR = {PAR!r}\nPULSARS = {PULSARS!r}\nWAVES = {WAVES!r}\n"
              + textwrap.dedent(_REF_SCRIPT))
    return run_reference(script, work / "ref.npz")


@pytest.fixture(scope="module")
def pulsars(ref):
    return [(ref["__meta__"]["pars"][j], load_state(ref, f"p{j}")["bundle"])
            for j in range(3)]


def _wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# -- discovery + env knobs ------------------------------------------------
def test_serving_devices_discovery():
    assert serving_devices("cpu") == [torch.device("cpu")]
    assert len(serving_devices("cpu", 3)) == 3
    assert len(serving_devices("cpu", 0)) == 1  # 0 = the default
    assert serving_devices("cuda:0", 2) == [torch.device("cuda", 0)] * 2


def test_pool_env_knobs(monkeypatch):
    monkeypatch.setenv("PINT_TPU_SERVE_REPLICAS", "3")
    monkeypatch.setenv("PINT_TPU_SERVE_QUARANTINE_N", "5")
    monkeypatch.setenv("PINT_TPU_SERVE_AFFINITY", "2")
    eng = TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0)
    try:
        assert eng.pool.size == 3
        assert all(r.quarantine_n == 5 for r in eng.pool.replicas)
        assert eng.router.affinity == 2
        st = eng.stats()
        assert st["fabric"]["replicas"] == 3
        assert set(st["fabric"]["per_replica"]) == {"r0", "r1", "r2"}
    finally:
        eng.close(timeout=60)


# -- router policy units --------------------------------------------------
class FakeReplica:
    def __init__(self, rid, state=LIVE, outstanding=0, inflight=1):
        self.rid = rid
        self.tag = f"r{rid}"
        self.state = state
        self.outstanding = outstanding
        self.inflight = inflight
        self.draining = False


class FakePool:
    def __init__(self, reps):
        self.replicas = reps

    @property
    def size(self):
        return len(self.replicas)


def _work():
    return types.SimpleNamespace(key=("fit", "comp", 64), live=[1, 2])


def test_router_sticky_placement_and_least_loaded():
    reps = [FakeReplica(0, outstanding=2), FakeReplica(1),
            FakeReplica(2, outstanding=1)]
    router = Router(FakePool(reps))
    w = _work()
    assert router.route(w).rid == 1
    assert router.route(w).rid == 1
    assert router.placement(w.key) == (1,)


def test_router_spills_only_under_saturation():
    reps = [FakeReplica(0), FakeReplica(1), FakeReplica(2)]
    router = Router(FakePool(reps), affinity=2)
    w = _work()
    assert router.route(w).rid == 0
    reps[0].outstanding = 1
    assert router.route(w).rid == 0
    assert router.placement(w.key) == (0,)
    reps[0].outstanding = 2
    s0 = obs_metrics.counter("serve.fabric.spills").value
    assert router.route(w).rid == 1
    assert router.placement(w.key) == (0, 1)
    assert obs_metrics.counter("serve.fabric.spills").value == s0 + 1
    reps[1].outstanding = 2
    assert router.route(w).rid in (0, 1)  # affinity=2: no 3rd spill
    assert router.placement(w.key) == (0, 1)


def test_router_skips_quarantined_and_excluded():
    reps = [FakeReplica(0), FakeReplica(1), FakeReplica(2)]
    router = Router(FakePool(reps))
    w = _work()
    assert router.route(w).rid == 0
    reps[0].state = QUARANTINED
    r = router.route(w)
    assert r.rid == 1
    assert router.placement(w.key) == (0, 1)
    assert router.route(w, exclude={0, 1}).rid == 2
    reps[1].state = DEGRADED
    assert router.route(w, exclude={2}).rid == 1
    reps[1].state = QUARANTINED
    reps[2].draining = True
    assert router.route(w) is None


def test_router_cold_placement_is_least_loaded_at_small_buckets(
        monkeypatch):
    """With cross-key fusion off, a new group lands on the least-loaded
    replica whatever its bucket: small groups are not piled onto the
    replica that holds the most of them (that colocation serves the
    fuser, ``test_router_colocates_small_groups_for_fusion``)."""
    monkeypatch.setenv("PINT_TPU_SERVE_XKEY_FUSE", "0")
    reps = [FakeReplica(0), FakeReplica(1)]
    router = Router(FakePool(reps))
    first = types.SimpleNamespace(key=("fit", "a", 64), live=[1])
    second = types.SimpleNamespace(key=("fit", "b", 64), live=[1])
    assert router.route(first).rid == 0
    reps[0].outstanding = 1
    assert router.route(second).rid == 1
    assert router.stats() == {"groups": 2, "placement_widths": [1, 1]}


def test_router_colocates_small_groups_for_fusion():
    """Fusion on: a cold SMALL group prefers the replica already holding
    other small groups (the fuser merges only co-resident batches); a big
    group keeps the least-loaded placement."""
    reps = [FakeReplica(0), FakeReplica(1)]
    router = Router(FakePool(reps))
    assert router.xkey_fuse and router.xkey_threshold == 4096
    first = types.SimpleNamespace(key=("fit", "a", 64), live=[1])
    second = types.SimpleNamespace(key=("fit", "b", 64), live=[1])
    big = types.SimpleNamespace(key=("fit", "c", 8192), live=[1])
    assert router.route(first).rid == 0
    reps[0].outstanding = 1
    assert router.route(second).rid == 0
    assert router.route(big).rid == 1
    # the background quanta of the job scheduler count as load
    reps[0].outstanding, reps[1].background = 0, 2
    third = types.SimpleNamespace(key=("fit", "d", 8192), live=[1])
    assert router.route(third).rid == 0


def test_router_round_robins_among_tied_placed_replicas():
    reps = [FakeReplica(0, outstanding=2), FakeReplica(1, outstanding=2)]
    router = Router(FakePool(reps), affinity=2)
    w = _work()
    router.route(w)
    router.route(w)  # r0 saturated: the group spills to r1
    assert router.placement(w.key) == (0, 1)
    reps[0].outstanding = reps[1].outstanding = 1
    seq = [router.route(w).rid for _ in range(4)]
    assert sorted(seq[:2]) == [0, 1] and seq[2:] == seq[:2]


def test_router_prefers_a_live_peer_over_a_degraded_one():
    reps = [FakeReplica(0, outstanding=2), FakeReplica(1, outstanding=2)]
    router = Router(FakePool(reps), affinity=2)
    w = _work()
    router.route(w)
    router.route(w)
    assert router.placement(w.key) == (0, 1)
    reps[0].state = DEGRADED
    reps[0].outstanding = 0
    reps[1].outstanding = 1
    assert router.route(w).rid == 1  # LIVE, though more loaded
    reps[1].state = QUARANTINED
    assert router.route(w).rid == 0  # the degraded one, as the last


# -- health state machine -------------------------------------------------
def test_replica_health_machine_and_probe():
    pool = ReplicaPool(
        device="cpu", replicas=2, inflight=1, quarantine_n=2,
        probe_interval_s=30.0, requeue=lambda w, r: None,
        finisher=lambda w, m, r: None, validator=lambda w, m, t: None,
    )
    try:
        r = pool.replica(0)
        q0 = obs_metrics.counter("serve.fabric.quarantines").value
        assert r.state == LIVE
        r.note_failure("watchdog")
        assert r.state == DEGRADED
        r.note_success()
        assert r.state == LIVE
        r.note_failure("nan")
        r.note_failure("nan")
        assert r.state == QUARANTINED
        assert obs_metrics.counter("serve.fabric.quarantines").value \
            == q0 + 1
        assert len(pool.live) == 1
        assert r.probe()
        r.readmit()
        assert r.state == LIVE
        assert len(pool.live) == 2
    finally:
        pool.drain(timeout=60)
    assert all(r.state == DRAINED for r in pool.replicas)


# -- fault injection: quarantine -> reroute -> probe -> readmit -----------
def test_hang_pinned_to_one_replica_quarantines_and_readmits(pulsars):
    eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=1.0,
                       inflight=1, replicas=3, quarantine_n=2, probe_ms=50,
                       max_queue=64)
    try:
        with obs_trace.tracing(clear=True):
            par, toas = pulsars[0]
            r = eng.submit(ResidualsRequest(par=par, toas=toas)).result(
                timeout=120)
            assert r.replica == "r0"
            pair = [eng.submit(ResidualsRequest(par=p, toas=t))
                    for p, t in pulsars[:2]]
            assert all(f.result(timeout=120).replica == "r0" for f in pair)
            for rep in eng.pool.replicas:
                assert rep.probe()
            q0 = obs_metrics.counter("serve.fabric.quarantines").value
            with guard.configured(compile_timeout=20.0,
                                  dispatch_timeout=0.4, max_retries=0):
                with faults.inject("hang:inf@r0", hang_seconds=2.0):
                    futs = [eng.submit(ResidualsRequest(par=p, toas=t))
                            for p, t in (pulsars * 2)]
                    for f in futs:
                        assert f.result(timeout=120).replica != "r0"
                    _wait_for(lambda: eng.pool.replica(0).state
                              == QUARANTINED, 20, "r0 quarantine")
                    p0 = obs_metrics.counter("serve.fabric.probes").value
                    _wait_for(lambda: obs_metrics.counter(
                        "serve.fabric.probes").value > p0, 20,
                        "a canary probe attempt")
                    assert eng.pool.replica(0).state == QUARANTINED
                _wait_for(lambda: eng.pool.replica(0).state == LIVE, 30,
                          "r0 re-admission")
            assert obs_metrics.counter("serve.fabric.quarantines").value \
                > q0
            assert eng.stats()["fabric"]["readmits"] >= 1
            assert eng.stats()["fabric"]["reroutes"] >= 1
            report = obs_export.flight_report()
            assert "quarantines" in report and "readmits" in report
            assert "replica-state" in report
            r2 = eng.submit(ResidualsRequest(par=par, toas=toas)).result(
                timeout=120)
            assert np.array_equal(r2.residuals_s, r.residuals_s)
    finally:
        eng.close(timeout=60)


def test_nan_pinned_to_one_replica_quarantines_and_recovers(pulsars):
    eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=1.0,
                       inflight=1, replicas=3, quarantine_n=1, probe_ms=50,
                       max_queue=64)
    try:
        par, toas = pulsars[1]
        warm = eng.submit(FitRequest(par=par, toas=toas, maxiter=2)
                          ).result(timeout=120)
        assert warm.replica == "r0"
        with faults.inject("nan:inf@r0"):
            futs = [eng.submit(FitRequest(par=p, toas=t, maxiter=2))
                    for p, t in (pulsars * 2)]
            for f in futs:
                resp = f.result(timeout=120)
                assert resp.replica != "r0"
                assert np.isfinite(resp.chi2)
            _wait_for(lambda: eng.pool.replica(0).state == QUARANTINED,
                      20, "r0 quarantine under NaN injection")
            assert not eng.pool.replica(0).probe()
        _wait_for(lambda: eng.pool.replica(0).state == LIVE, 30,
                  "r0 re-admission after NaN cleared")
        again = eng.submit(FitRequest(par=par, toas=toas, maxiter=2)
                           ).result(timeout=120)
        assert again.chi2 == warm.chi2
    finally:
        eng.close(timeout=60)


# -- placement parity -----------------------------------------------------
def _stream(eng, pulsars):
    out = []
    for wave in WAVES:
        futs = []
        for op, i in wave:
            par, toas = pulsars[i]
            req = (ResidualsRequest(par=par, toas=toas) if op == "residuals"
                   else FitRequest(par=par, toas=toas, maxiter=2))
            futs.append(eng.submit(req))
        out.extend(f.result(timeout=120) for f in futs)
    return out


def test_parity_1_vs_4_replica_fabric(pulsars, ref):
    """Identical request stream through a 1-replica and a 4-replica
    fabric: bitwise-identical responses per request — placement must not
    change numerics — and both at the JAX engine's responses."""

    def burst(eng):
        futs = [eng.submit(FitRequest(par=pulsars[i % 3][0],
                                      toas=pulsars[i % 3][1], maxiter=2))
                for i in range(16)]
        futs += [eng.submit(ResidualsRequest(par=pulsars[i % 3][0],
                                             toas=pulsars[i % 3][1]))
                 for i in range(16)]
        for f in futs:
            f.result(timeout=120)

    kw = dict(device="cpu", max_batch=4, max_wait_ms=100.0, inflight=1,
              max_queue=128)
    with TimingEngine(replicas=1, **kw) as e1:
        burst(e1)
        out1 = _stream(e1, pulsars)
    with TimingEngine(replicas=4, affinity=4, **kw) as e4:
        burst(e4)
        out4 = _stream(e4, pulsars)
        spills = e4.stats()["fabric"]["spills"]
    assert spills >= 1
    assert len({r.replica for r in out4}) >= 2
    assert {r.replica for r in out1} == {"r0"}
    for k, (a, b) in enumerate(zip(out1, out4)):
        assert type(a) is type(b)
        assert a.ntoa == b.ntoa and a.bucket == b.bucket
        assert a.batch_size == b.batch_size == int(ref[f"s{k}/batch"])
        if hasattr(a, "residuals_s"):
            np.testing.assert_array_equal(a.residuals_s, b.residuals_s)
            np.testing.assert_allclose(a.residuals_s, ref[f"s{k}/res"],
                                       rtol=1e-9, atol=1e-15)
            assert a.chi2 == pytest.approx(float(ref[f"s{k}/chi2"]),
                                           rel=1e-9)
        else:
            np.testing.assert_array_equal(a.deltas, b.deltas)
            np.testing.assert_array_equal(a.uncertainties, b.uncertainties)
            assert a.fitted_par == b.fitted_par
            assert a.chi2 == pytest.approx(float(ref[f"s{k}/chi2"]),
                                           rel=1e-6)
            np.testing.assert_allclose(a.uncertainties, ref[f"s{k}/unc"],
                                       rtol=1e-5)
            assert np.all(np.abs(a.deltas - ref[f"s{k}/deltas"])
                          <= 1e-3 * ref[f"s{k}/unc"])
        assert a.chi2 == b.chi2


# -- in-replica batch coalescing ------------------------------------------
def _mk_work(key, nlive, cap, base, excluded=()):
    """Synthetic BatchWork: distinct real rows (value encodes live
    index), pad rows repeating row 0 — the engine _assemble shape."""
    live = [types.SimpleNamespace(idx=base + j) for j in range(nlive)]
    real = base + np.arange(nlive, dtype=float)
    a = real[:, None] * np.array([1.0, 10.0, 100.0])
    b = real.copy()

    def pad(leaf):
        extra = cap - leaf.shape[0]
        if extra:
            leaf = np.concatenate([leaf, np.repeat(leaf[:1], extra,
                                                   axis=0)])
        return leaf

    w = BatchWork(key, live, (pad(a), pad(b)), session="sess", cap=cap)
    w.excluded = set(excluded)
    return w


def test_merge_batch_works_row_alignment_and_padding():
    key = ("residuals", "comp", 64, True)
    a = _mk_work(key, 2, 4, base=0, excluded={1})
    b = _mk_work(key, 3, 4, base=10, excluded={2})
    m = merge_batch_works([a, b], 8)
    assert m.cap == 8 and m.key == key and m.session == "sess"
    assert [p.idx for p in m.live] == [0, 1, 10, 11, 12]
    la, lb = m.ops
    expect = np.array([0.0, 1.0, 10.0, 11.0, 12.0])
    np.testing.assert_array_equal(lb[:5], expect)
    np.testing.assert_array_equal(la[:5], expect[:, None]
                                  * np.array([1.0, 10.0, 100.0]))
    np.testing.assert_array_equal(lb[5:], np.repeat(lb[:1], 3))
    np.testing.assert_array_equal(la[5:], np.tile(la[:1], (3, 1)))
    assert m.excluded == {1, 2}
    with pytest.raises(PintTpuError):
        merge_batch_works([a, b], 4)


def _bare_replica():
    """A thread-less Replica shell: enough state for the _coalesce
    decision logic."""
    r = object.__new__(Replica)
    r.tag = "rX"
    r._cond = threading.Condition()
    r._queue = collections.deque()
    r._kernels = {}
    r._coalesce_on = True
    r._overlap_on = True
    r._xkey_on = True
    r._xkey_threshold = 4096
    r._xkey_max = 4
    r._outstanding = 0
    r._g_out = obs_metrics.gauge("serve.replica.test.outstanding")
    return r


def test_coalesce_only_lands_on_warmed_capacities():
    key = ("residuals", "comp", 64, True)
    other = ("residuals", "comp2", 64, True)
    r = _bare_replica()
    head = _mk_work(key, 2, 2, base=0)
    r._queue.append(_mk_work(key, 1, 1, base=10))
    r._outstanding = 2
    assert r._coalesce(head) is head
    assert len(r._queue) == 1 and r._outstanding == 2
    r._kernels[(key, 4)] = lambda *a: None
    r._queue.append(_mk_work(other, 1, 1, base=20))
    r._outstanding = 3
    merged = r._coalesce(head)
    assert merged is not head
    assert [p.idx for p in merged.live] == [0, 1, 10]
    assert merged.cap == 4
    assert [w.key for w in r._queue] == [other]
    assert r._outstanding == 2


def test_coalesce_disabled_by_env(monkeypatch):
    monkeypatch.setenv("PINT_TPU_SERVE_COALESCE", "0")
    eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=1.0,
                       replicas=1)
    try:
        assert all(not rep._coalesce_on for rep in eng.pool.replicas)
        w = object()  # pass-through when disabled: never inspected
        assert eng.pool.replica(0)._coalesce(w) is w
    finally:
        eng.close(timeout=60)


def test_coalesce_merges_queued_same_key_batches(pulsars):
    """Batches co-resident behind a stalled dispatch merge into ONE
    stacked dispatch on an already-built capacity — the coalesced counter
    moves, responses stay bitwise-identical, and NO program is built."""
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=40.0,
                       inflight=8, replicas=1, max_queue=64)
    try:
        par, toas = pulsars[0]

        def wave(n):
            futs = [eng.submit(ResidualsRequest(par=par, toas=toas))
                    for _ in range(n)]
            return [f.result(timeout=120) for f in futs]

        warm = wave(1)[0]
        assert {r.batch_size for r in wave(2)} == {2}
        assert {r.batch_size for r in wave(4)} == {4}
        c0 = obs_metrics.counter("serve.fabric.coalesced").value
        traces0 = obs_metrics.counter("compile.traces").value
        with faults.inject("hang:1@serve:residuals", hang_seconds=2.0):
            first = eng.submit(ResidualsRequest(par=par, toas=toas))
            time.sleep(0.3)  # its 1-row batch flushed and is hanging
            pair1 = [eng.submit(ResidualsRequest(par=par, toas=toas))
                     for _ in range(2)]
            time.sleep(0.25)  # > max_wait: forces a SECOND 2-row batch
            pair2 = [eng.submit(ResidualsRequest(par=par, toas=toas))
                     for _ in range(2)]
            out = [f.result(timeout=120) for f in [first, *pair1, *pair2]]
        assert obs_metrics.counter("serve.fabric.coalesced").value >= c0 + 1
        assert [r.batch_size for r in out[1:]] == [4, 4, 4, 4]
        for r in out:
            np.testing.assert_array_equal(r.residuals_s, warm.residuals_s)
            assert r.chi2 == warm.chi2
        assert obs_metrics.counter("compile.traces").value == traces0
        assert eng.stats()["fabric"]["coalesced"] >= 1
    finally:
        eng.close(timeout=60)


# -- cross-key fused dispatches ------------------------------------------------
def test_xkey_fuse_policy_gates():
    """Unit-level fusion policy: distinct built identities fuse, members
    keep their _outstanding units; cold members, no_fuse retries,
    same-key neighbours, big buckets and the member cap all leave the
    queue untouched."""
    key_a = ("residuals", "compA", 64, True)
    key_b = ("residuals", "compB", 64, True)
    r = _bare_replica()
    head = _mk_work(key_a, 2, 2, base=0)
    r._queue.append(_mk_work(key_b, 1, 1, base=10))
    r._outstanding = 2
    # neither the combo nor the members' solo programs built: no fuse
    assert r._fuse(head) is head
    assert len(r._queue) == 1
    r._kernels[(key_a, 2)] = lambda *a: None
    r._kernels[(key_b, 1)] = lambda *a: None
    fused = r._fuse(head)
    assert isinstance(fused, FusedBatch)
    assert {w.key for w in fused.members} == {key_a, key_b}
    assert not r._queue
    # members keep INDIVIDUAL outstanding units (each fences its own
    # _batch_leaves at de-multiplex — unlike the coalescer's merge)
    assert r._outstanding == 2
    idents = tuple(w.kernel_key() for w in fused.members)
    assert idents == tuple(sorted(idents, key=repr))
    assert fused.combo == ("xkey",) + idents
    # a fused-failure retry (no_fuse) never fuses again
    head2 = _mk_work(key_a, 2, 2, base=0)
    head2.no_fuse = True
    r._queue.append(_mk_work(key_b, 1, 1, base=20))
    assert r._fuse(head2) is head2
    assert len(r._queue) == 1
    # same-identity neighbours are the coalescer's business
    r._queue.clear()
    r._queue.append(_mk_work(key_a, 1, 2, base=30))
    head3 = _mk_work(key_a, 2, 2, base=0)
    assert r._fuse(head3) is head3
    assert len(r._queue) == 1
    # big buckets never fuse (bucket is key[2])
    big = ("residuals", "compC", 8192, True)
    r._queue.clear()
    r._queue.append(_mk_work(key_b, 1, 1, base=40))
    r._kernels[(big, 1)] = lambda *a: None
    bighead = _mk_work(big, 1, 1, base=50)
    assert r._fuse(bighead) is bighead
    # the member cap bounds a combo's width
    r._xkey_max = 2
    key_c = ("residuals", "compC2", 64, True)
    r._kernels[(key_c, 1)] = lambda *a: None
    r._queue.clear()
    r._queue.append(_mk_work(key_b, 1, 1, base=60))
    r._queue.append(_mk_work(key_c, 1, 1, base=70))
    fused2 = r._fuse(_mk_work(key_a, 2, 2, base=80))
    assert isinstance(fused2, FusedBatch)
    assert len(fused2.members) == 2
    assert len(r._queue) == 1
    # the hatch restores pass-through
    r._xkey_on = False
    r._queue.append(_mk_work(key_b, 1, 1, base=90))
    head4 = _mk_work(key_a, 2, 2, base=100)
    assert r._fuse(head4) is head4


def test_xkey_fuse_disabled_by_env(monkeypatch):
    monkeypatch.setenv("PINT_TPU_SERVE_XKEY_FUSE", "0")
    monkeypatch.setenv("PINT_TPU_SERVE_OVERLAP", "0")
    eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=1.0,
                       replicas=1)
    try:
        assert all(not rep._xkey_on and not rep._overlap_on
                   for rep in eng.pool.replicas)
        w = _mk_work(("residuals", "comp", 64, True), 1, 1, base=0)
        assert eng.pool.replica(0)._fuse(w) is w
        assert not eng.router.xkey_fuse
    finally:
        eng.close(timeout=60)


def _fused_round(eng, residuals, fit, extra=()):
    """Stall the first residuals dispatch so that the next residuals
    batch and the fit batch sit together in r0's queue when the
    dispatcher wakes."""
    with faults.inject("hang:1@serve:residuals", hang_seconds=1.5):
        first = residuals()
        time.sleep(0.3)
        futs = [first, residuals(), fit(), *[f() for f in extra]]
        time.sleep(0.1)
        return futs


def test_xkey_fuse_bitwise_parity_and_zero_steady_builds(pulsars, ref):
    """A residuals batch and a fit batch of DIFFERENT group keys,
    co-resident behind a stalled dispatch, serve as ONE fused program:
    the xkey counter moves, every response is bitwise its solo warm-up's
    (and at the JAX engine's responses), and the SECOND fused round (the
    combo built) builds nothing."""
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=40.0,
                       inflight=8, replicas=1, max_queue=64)
    try:
        par_r, toas_r = pulsars[1]
        par_f, toas_f = pulsars[2]

        def residuals():
            return eng.submit(ResidualsRequest(par=par_r, toas=toas_r))

        def fit():
            return eng.submit(FitRequest(par=par_f, toas=toas_f,
                                         maxiter=2))

        warm_r = residuals().result(timeout=120)
        warm_f = fit().result(timeout=120)
        fused0 = obs_metrics.counter("serve.fabric.xkey_fused").value
        out1 = [f.result(timeout=120) for f in _fused_round(
            eng, residuals, fit)]
        assert (obs_metrics.counter("serve.fabric.xkey_fused").value
                > fused0)
        traces0 = obs_metrics.counter("compile.traces").value
        retraces0 = obs_metrics.counter("compile.recompiles").value
        out2 = [f.result(timeout=120) for f in _fused_round(
            eng, residuals, fit)]
        assert obs_metrics.counter("compile.traces").value == traces0
        assert (obs_metrics.counter("compile.recompiles").value
                == retraces0)
        for out in (out1, out2):
            for r in out[:2]:
                np.testing.assert_array_equal(r.residuals_s,
                                              warm_r.residuals_s)
                assert r.chi2 == warm_r.chi2
            f = out[2]
            np.testing.assert_array_equal(f.deltas, warm_f.deltas)
            np.testing.assert_array_equal(f.uncertainties,
                                          warm_f.uncertainties)
            assert f.chi2 == warm_f.chi2
            assert f.fitted_par == warm_f.fitted_par
        # the JAX engine's solo responses for the same pars (WAVES: s1 is
        # pulsar 1's residuals, s5 pulsar 2's fit)
        np.testing.assert_allclose(warm_r.residuals_s, ref["s1/res"],
                                   rtol=1e-9, atol=1e-15)
        assert warm_f.chi2 == pytest.approx(float(ref["s5/chi2"]),
                                            rel=1e-6)
        np.testing.assert_allclose(warm_f.uncertainties, ref["s5/unc"],
                                   rtol=1e-5)
    finally:
        eng.close(timeout=60)


def test_xkey_fused_failure_degrades_to_solo(pulsars):
    """A NaN injected at the fused site fails typed, marks the members
    no_fuse, and their re-routed solo retries still serve — the fused
    overlay never wedges work that succeeds unfused."""
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=40.0,
                       inflight=8, replicas=2, quarantine_n=10,
                       max_queue=64)
    try:
        par_r, toas_r = pulsars[1]
        par_f, toas_f = pulsars[2]
        warm_r = eng.submit(ResidualsRequest(par=par_r, toas=toas_r)
                            ).result(timeout=120)
        warm_f = eng.submit(FitRequest(par=par_f, toas=toas_f, maxiter=2)
                            ).result(timeout=120)
        f0 = obs_metrics.counter("serve.fabric.xkey_fused").value
        with faults.inject("nan:inf@serve:xkey"):
            out = [f.result(timeout=120) for f in _fused_round(
                eng,
                lambda: eng.submit(ResidualsRequest(par=par_r,
                                                    toas=toas_r)),
                lambda: eng.submit(FitRequest(par=par_f, toas=toas_f,
                                              maxiter=2)))]
        assert obs_metrics.counter("serve.fabric.xkey_fused").value > f0
        np.testing.assert_array_equal(out[1].residuals_s,
                                      warm_r.residuals_s)
        np.testing.assert_array_equal(out[2].deltas, warm_f.deltas)
    finally:
        eng.close(timeout=60)


def test_xkey_nonfinite_member_fails_alone(pulsars):
    """One member of a fused dispatch with a non-finite result (a fit of
    TOAs one of whose uncertainties is NaN): only that member's future
    fails, typed; the other member of the same fused program resolves,
    bitwise solo."""
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=40.0,
                       inflight=8, replicas=1, quarantine_n=10,
                       max_queue=64)
    try:
        par_r, toas_r = pulsars[1]
        par_f, toas_f = pulsars[2]
        warm_r = eng.submit(ResidualsRequest(par=par_r, toas=toas_r)
                            ).result(timeout=120)
        eng.submit(FitRequest(par=par_f, toas=toas_f, maxiter=2)
                   ).result(timeout=120)
        bad = dict(toas_f, error_us=np.array(toas_f["error_us"]))
        bad["error_us"][0] = np.nan
        f0 = obs_metrics.counter("serve.fabric.xkey_fused").value
        futs = _fused_round(
            eng,
            lambda: eng.submit(ResidualsRequest(par=par_r, toas=toas_r)),
            lambda: eng.submit(FitRequest(par=par_f, toas=bad,
                                          maxiter=2)))
        np.testing.assert_array_equal(futs[1].result(timeout=120)
                                      .residuals_s, warm_r.residuals_s)
        with pytest.raises(PintTpuNumericsError):
            futs[2].result(timeout=120)
        assert obs_metrics.counter("serve.fabric.xkey_fused").value > f0
    finally:
        eng.close(timeout=60)


def _assembled(eng, req):
    """One request's batch through the engine's admission and stacking
    chokepoints, not routed."""
    from concurrent.futures import Future

    from pint_tpu_torch.serve.engine import _Pending

    p = _Pending(req, Future(), time.monotonic())
    rec, sess, padded, ntoa = eng._session_for_request(req)
    p.record, p.session, p.bundle, p.ntoa = rec, sess, padded, ntoa
    if req.op == "fit":
        key = ("fit", sess.composition, sess.bucket, sess.mode,
               int(req.maxiter), 1e-10 if sess.mode == "f64" else 3e-6)
    else:
        key = ("residuals", sess.composition, sess.bucket, True)
    return eng._assemble(key, [p])


def test_prewarm_fused_builds_the_combo_before_traffic(pulsars):
    """``Replica.prewarm_fused`` builds a combo's fused program off its
    members' built solo programs, so the first fused round of that combo
    builds nothing."""
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=40.0,
                       inflight=8, replicas=1, max_queue=64)
    try:
        par_r, toas_r = pulsars[1]
        par_f, toas_f = pulsars[2]

        def residuals():
            return eng.submit(ResidualsRequest(par=par_r, toas=toas_r))

        def fit():
            return eng.submit(FitRequest(par=par_f, toas=toas_f,
                                         maxiter=2))

        residuals().result(timeout=120)
        fit().result(timeout=120)
        rep = eng.pool.replica(0)
        works = [_assembled(eng, ResidualsRequest(par=par_r,
                                                  toas=toas_r)),
                 _assembled(eng, FitRequest(par=par_f, toas=toas_f,
                                            maxiter=2))]
        assert not rep.prewarm_fused(works[:1])  # one member: nothing
        traces0 = obs_metrics.counter("compile.traces").value
        assert rep.prewarm_fused(works)
        assert obs_metrics.counter("compile.traces").value == traces0 + 1
        f0 = obs_metrics.counter("serve.fabric.xkey_fused").value
        traces0 = obs_metrics.counter("compile.traces").value
        out = [f.result(timeout=120) for f in _fused_round(
            eng, residuals, fit)]
        assert obs_metrics.counter("serve.fabric.xkey_fused").value > f0
        assert obs_metrics.counter("compile.traces").value == traces0
        assert all(np.isfinite(r.chi2) for r in out)
    finally:
        eng.close(timeout=60)


def test_pool_prewarm_builds_before_traffic(pulsars):
    """``ReplicaPool.prewarm``: a batch's program warmed on every replica
    before any traffic, so the first request of that (key, capacity)
    builds nothing, and its response equals a cold engine's."""
    from concurrent.futures import Future

    from pint_tpu_torch.serve import batcher as bmod
    from pint_tpu_torch.serve.engine import _Pending
    from pint_tpu_torch.serve.session import request_bundles, request_table

    par, toas = pulsars[0]
    with TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0,
                      replicas=2) as cold:
        want = cold.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=120)
    with TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0,
                      replicas=2) as eng:
        req = ResidualsRequest(par=par, toas=toas)
        p = _Pending(req, Future(), time.monotonic())
        rec = eng.sessions.record_for(par)
        table = request_table(toas, rec.model)
        cpu, host = request_bundles(rec.model, table)
        sess = eng.sessions.session_for(rec, table, cpu)
        p.record, p.session, p.ntoa = rec, sess, cpu.ntoa
        p.bundle = bmod.pad_bundle_np(host, sess.bucket)
        work = eng._assemble(("residuals", sess.composition, sess.bucket,
                              True), [p])
        assert eng.pool.prewarm([work]) == 2
        assert all(r.kernel_count == 1 for r in eng.pool.replicas)
        traces0 = obs_metrics.counter("compile.traces").value
        got = eng.submit(req).result(timeout=120)
        assert obs_metrics.counter("compile.traces").value == traces0
        np.testing.assert_array_equal(got.residuals_s, want.residuals_s)


def test_total_outage_drain_resolves_everything_typed(pulsars):
    """All replicas wedged: every submitted future still resolves to a
    typed error and close() returns in bounded time — never a hang."""
    par, toas = pulsars[0]
    with guard.configured(compile_timeout=0.4, dispatch_timeout=0.4,
                          max_retries=0):
        with faults.inject("hang:inf@serve:", hang_seconds=2.0):
            eng = TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0,
                               inflight=1, replicas=2, quarantine_n=1,
                               probe_ms=50, max_queue=32)
            t0 = time.monotonic()
            futs = [eng.submit(ResidualsRequest(par=par, toas=toas))
                    for _ in range(5)]
            eng.close(timeout=60)
            for f in futs:
                with pytest.raises((GuardTimeout, RetriesExhausted,
                                    RequestRejected, PintTpuNumericsError)):
                    f.result(timeout=30)
            wall = time.monotonic() - t0
    assert wall < 45.0


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _card_pulsars(n=3, ntoa=256):
    from pint_tpu_torch.simulation import make_test_pulsar

    out = []
    for i, f0, dm, _, seed in PULSARS[:n]:
        m, t = make_test_pulsar(PAR.format(i=i, f0=f0, dm=dm), ntoa=ntoa,
                                seed=seed, iterations=1, device="cpu")
        out.append((m.as_parfile(), t))
    return out


@pytest.mark.gpu
def test_card_two_replicas_on_one_card_serve_alike():
    """Two replicas on one card, each with its stream and programs: a
    stream of waves spread over both returns what one replica returns."""
    dev = _card()
    ps = _card_pulsars()
    kw = dict(device=dev, max_batch=4, max_wait_ms=50.0, inflight=1,
              max_queue=128)
    with TimingEngine(replicas=1, **kw) as e1:
        out1 = _stream(e1, ps)
    with TimingEngine(replicas=2, affinity=2, **kw) as e2:
        assert [r.device.type for r in e2.pool.replicas] == ["cuda"] * 2
        for _ in range(2):
            for f in e2.submit_many([FitRequest(par=p, toas=t, maxiter=2)
                                     for p, t in ps * 4]):
                f.result(timeout=300)
        out2 = _stream(e2, ps)
        caps = [r.programs.captures for r in e2.pool.replicas]
    assert all(c >= 1 for c in caps), caps
    for a, b in zip(out1, out2):
        assert a.chi2 == pytest.approx(b.chi2, rel=1e-9)


@pytest.mark.gpu
def test_card_capture_beside_another_replicas_replays():
    """One replica captures a new program while the other replays its
    warmed one: both captures stay valid and every result is finite (the
    device lock takes a capture and the other replica's launches in
    turns)."""
    dev = _card()
    ps = _card_pulsars()
    with TimingEngine(device=dev, replicas=2, affinity=1, max_batch=4,
                      max_wait_ms=5.0, inflight=2, max_queue=256) as eng:
        par, toas = ps[0]
        eng.submit(ResidualsRequest(par=par, toas=toas)).result(timeout=300)
        stop = threading.Event()
        errors = []

        def replays():
            while not stop.is_set():
                try:
                    eng.submit(ResidualsRequest(par=par, toas=toas)
                               ).result(timeout=300)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        th = threading.Thread(target=replays)
        th.start()
        try:
            fits = [f.result(timeout=300) for f in eng.submit_many(
                [FitRequest(par=p, toas=t, maxiter=2) for p, t in ps])]
        finally:
            stop.set()
            th.join(timeout=300)
        assert not errors, errors
        assert all(np.isfinite(f.chi2) for f in fits)
        assert sum(r.programs.captures for r in eng.pool.replicas) >= 2


@pytest.mark.gpu
def test_card_wedged_kernel_seen_at_the_fence():
    """A hang injected at a served batch's site wedges its launch on the
    card: the fence raises GuardTimeout at the watchdog's deadline (not
    when the kernel ends), and the next batch is served."""
    dev = _card()
    ps = _card_pulsars(1)
    par, toas = ps[0]
    with TimingEngine(device=dev, replicas=1, max_batch=1, max_wait_ms=0.0,
                      inflight=1, probe_ms=60_000) as eng:
        first = eng.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=300)
        torch.cuda.synchronize()
        with guard.configured(dispatch_timeout=0.3, max_retries=0):
            with faults.inject("hang:1@serve:residuals", hang_seconds=1.5):
                t0 = time.monotonic()
                with pytest.raises(GuardTimeout) as ei:
                    eng.submit(ResidualsRequest(par=par, toas=toas)
                               ).result(timeout=120)
                seen = time.monotonic() - t0
        assert ei.value.launched
        assert 0.3 <= seen < 0.45
        after = eng.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=300)
        np.testing.assert_array_equal(after.residuals_s, first.residuals_s)


@pytest.mark.gpu
def test_card_fused_capture_is_bitwise_solo():
    """On the card: a residuals batch and a fit batch of different keys,
    co-resident behind a stalled dispatch (the hang fires as a spinning
    kernel and on the dispatcher's host thread), run as ONE captured
    fused program — bitwise the same batches dispatched solo — and a
    second fused round captures nothing."""
    dev = _card()
    ps = _card_pulsars()
    with TimingEngine(device=dev, replicas=1, max_batch=4,
                      max_wait_ms=40.0, inflight=4, max_queue=64,
                      probe_ms=60_000) as eng:
        rep = eng.pool.replicas[0]
        (par_r, toas_r), (par_f, toas_f) = ps[1], ps[2]

        def residuals():
            return eng.submit(ResidualsRequest(par=par_r, toas=toas_r))

        def fit():
            return eng.submit(FitRequest(par=par_f, toas=toas_f,
                                         maxiter=2))

        def fused_round():
            with faults.inject("hang:2@serve:residuals", hang_seconds=1.0):
                first = residuals()
                time.sleep(0.3)
                futs = [first, residuals(), fit()]
                return [f.result(timeout=300) for f in futs]

        solo_r = residuals().result(timeout=300)
        solo_f = fit().result(timeout=300)
        f0 = obs_metrics.counter("serve.fabric.xkey_fused").value
        out1 = fused_round()
        assert obs_metrics.counter("serve.fabric.xkey_fused").value > f0
        caps = rep.programs.captures
        out2 = fused_round()
        assert rep.programs.captures == caps
        for out in (out1, out2):
            np.testing.assert_array_equal(out[1].residuals_s,
                                          solo_r.residuals_s)
            np.testing.assert_array_equal(out[2].deltas, solo_f.deltas)
            assert out[2].chi2 == solo_f.chi2
