"""The port's warm-restart ledger (``pint_tpu_torch/serve/warm_ledger.py``)
on the CPU.

Port twins of ``tests/test_warm_ledger.py``: the round trip (traffic
through a ledgered engine records exactly the built (composition, op,
bucket) x (capacity, placement) surface at each program's first call; a
FRESH engine on the same ledger replays it before its collector starts
and then serves the same traffic building nothing), the replay's
capacity ceiling, every bad ledger a clean cold boot (unparsable,
version-stale, malformed entry, and the corruption battery: a truncated
index, a version-stale sidecar, an unpicklable sidecar), a bad sidecar
skipping its entry, the path resolution and explicit enablement, a
failing ledger never raising into a dispatch, and the LRU bound.  Beyond
the reference's file: job programs replay too, the sidecar holds host
arrays only, and — the port's departure — neither package loads the
other's ledger or sidecar: one reference subprocess boots the JAX engine
on the port's ledger (a stale, cold boot), writes its own ledger beside
it, and serves the same residuals the port's engines are held to.
"""

import json
import os
import pickle
import sys
import textwrap
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.serve import ResidualsRequest, TimingEngine  # noqa: E402
from pint_tpu_torch.serve import warm_ledger as wlmod  # noqa: E402
from pint_tpu_torch.serve.api import JobRequest  # noqa: E402

PAR = """
PSR              J0101+01{i:02d}
F0               {f0}  1
F1               -1.3e-15           1
PEPOCH           55000
DM               {dm}             1
"""
PULSARS = [(0, 113.7, 9.0, 40, 21), (1, 187.1, 17.0, 48, 22)]

_REF_SCRIPT = """
from pint_tpu.obs import metrics as om
from pint_tpu.serve import ResidualsRequest, TimingEngine
from pint_tpu.simulation import make_test_pulsar

pulsars = []
for j, (i, f0, dm, n, seed) in enumerate(PULSARS):
    m, t = make_test_pulsar(PAR.format(i=i, f0=f0, dm=dm), ntoa=n,
                            seed=seed, iterations=1)
    export_state(m.compile(t), f"p{j}")
    pulsars.append((m.as_parfile(), t))
META["pars"] = [p for p, _ in pulsars]
# boot the JAX engine on the port's ledger: a stale, cold boot
s0 = om.counter("serve.warm.stale").value
r0 = om.counter("serve.warm.replayed").value
with TimingEngine(warm_ledger=PORT_LEDGER, max_batch=4, max_wait_ms=2.0,
                  inflight=1, replicas=1) as eng:
    META["stale"] = om.counter("serve.warm.stale").value - s0
    META["replayed"] = om.counter("serve.warm.replayed").value - r0
# the reference's own ledger, written beside the port's
with TimingEngine(warm_ledger=REF_LEDGER, max_batch=4, max_wait_ms=2.0,
                  inflight=1, replicas=1) as eng:
    for j, (par, t) in enumerate(pulsars):
        r = eng.submit(ResidualsRequest(par=par, toas=t)).result(
            timeout=300)
        OUT[f"res{j}"] = r.residuals_s
"""

ENGINE_KW = dict(device="cpu", max_batch=4, max_wait_ms=2.0, inflight=1,
                 replicas=1)


def _counter(name):
    return obs_metrics.counter(name).value


def _targeted_work(eng, group):
    """One residuals batch assembled through the engine's own admission
    and stacking chokepoints (the session resolution of ``_admit``, then
    ``_assemble``), not routed: -> (work, futures)."""
    from pint_tpu_torch.serve.engine import _Pending

    live, key = [], None
    for par, toas in group:
        req = ResidualsRequest(par=par, toas=toas)
        req.validate()
        p = _Pending(req, Future(), time.monotonic())
        rec, sess, padded, ntoa = eng._session_for_request(req)
        p.record, p.session, p.bundle, p.ntoa = rec, sess, padded, ntoa
        key = ("residuals", sess.composition, sess.bucket, True)
        live.append(p)
    work = eng._assemble(key, live)
    return work, [p.future for p in live]


def _drive(eng, pulsars):
    """Warm capacities 1 and 2 DETERMINISTICALLY (targeted assembly: the
    collector's batching must not decide what the ledger records)."""
    for group in ([pulsars[0]], pulsars[:2]):
        work, futs = _targeted_work(eng, group)
        eng._dispatch(work)
        for f in futs:
            f.result(timeout=300)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """(pulsars, the reference's output, port ledger dir, reference ledger
    path): the port's ledger is written first, the reference then boots
    on it and writes its own."""
    from pint_tpu_torch.simulation import make_test_pulsar

    work = tmp_path_factory.mktemp("torch_warm_ledger")
    port_dir = work / "port"
    port_ledger = str(port_dir / "ledger.json")
    ref_ledger = str(work / "ref" / "ledger.json")
    # a port ledger of the port's own pulsars (any composition will do)
    own = []
    for i, f0, dm, n, seed in PULSARS:
        m, t = make_test_pulsar(PAR.format(i=i, f0=f0, dm=dm), ntoa=n,
                                seed=seed, iterations=1, device="cpu")
        own.append((m.as_parfile(), t))
    eng = TimingEngine(warm_ledger=port_ledger, **ENGINE_KW)
    try:
        _drive(eng, own)
    finally:
        eng.close(timeout=60)
    script = (f"PAR = {PAR!r}\nPULSARS = {PULSARS!r}\n"
              f"PORT_LEDGER = {port_ledger!r}\n"
              f"REF_LEDGER = {ref_ledger!r}\n"
              + textwrap.dedent(_REF_SCRIPT))
    ref = run_reference(script, work / "ref.npz")
    pulsars = [(ref["__meta__"]["pars"][j],
                load_state(ref, f"p{j}")["bundle"]) for j in range(2)]
    return pulsars, ref, port_ledger, ref_ledger


@pytest.fixture(scope="module")
def pulsars(shared):
    return shared[0]


# -- the round trip --------------------------------------------------------
def test_round_trip_records_then_replays_build_free(tmp_path, pulsars,
                                                    shared):
    ref = shared[1]
    lp = str(tmp_path / "warm-ledger.json")
    rec0 = _counter("serve.warm.recorded")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        _drive(eng, pulsars)
    finally:
        eng.close(timeout=60)
    # the ledger is exactly the built surface: one residuals entry of the
    # shared composition, caps {1, 2}, single placement
    assert _counter("serve.warm.recorded") - rec0 >= 1
    with open(lp) as f:
        doc = json.load(f)
    assert doc["version"] == wlmod.LEDGER_VERSION
    (entry,) = doc["entries"].values()
    assert entry["op"] == "residuals"
    assert entry["caps"] == [1, 2]
    assert entry["placements"] == ["single"]
    assert os.path.exists(tmp_path / entry["sidecar"])

    # generation 2: the boot replays (its builds come before the
    # collector), then the SAME mix builds nothing
    rep0 = _counter("serve.warm.replayed")
    eng2 = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        assert _counter("serve.warm.replayed") - rep0 == 2  # caps 1, 2
        assert eng2.stats()["warm"]["replay_s"] > 0
        t0 = _counter("compile.traces")
        _drive(eng2, pulsars)
        out = [f.result(timeout=300) for f in eng2.submit_many([
            ResidualsRequest(par=p, toas=t) for p, t in pulsars
        ])]
        assert _counter("compile.traces") - t0 == 0
    finally:
        eng2.close(timeout=60)
    # the replayed engine's answers are the JAX engine's
    for j, r in enumerate(out):
        np.testing.assert_allclose(r.residuals_s, ref[f"res{j}"],
                                   rtol=1e-9, atol=1e-15)


def test_replay_respects_capacity_ceiling(tmp_path, pulsars):
    """A generation-2 engine with a SMALLER max batch skips ledgered
    capacities it could never serve instead of building dead programs."""
    lp = str(tmp_path / "warm-ledger.json")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        _drive(eng, pulsars)  # caps 1 and 2
    finally:
        eng.close(timeout=60)
    rep0 = _counter("serve.warm.replayed")
    eng2 = TimingEngine(warm_ledger=lp, **dict(ENGINE_KW, max_batch=1))
    try:
        assert _counter("serve.warm.replayed") - rep0 == 1  # cap 1 only
    finally:
        eng2.close(timeout=60)


def test_job_programs_replay_at_boot(tmp_path, pulsars):
    """A grid job's program is ledgered at its first call; a restarted
    engine builds it at boot, and the same job then builds nothing."""
    lp = str(tmp_path / "warm-ledger.json")
    par, toas = pulsars[0]
    grid = {"F0": [113.7 + d for d in (-1e-9, 0.0, 1e-9)]}

    def job():
        return JobRequest(par=par, toas=toas, kind="grid_chisq",
                          grid=grid)

    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        first = eng.submit(job()).result(timeout=300)
    finally:
        eng.close(timeout=60)
    with open(lp) as f:
        ops = {e["op"] for e in json.load(f)["entries"].values()}
    assert "job" in ops
    rep0 = _counter("serve.warm.replayed")
    eng2 = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        assert _counter("serve.warm.replayed") - rep0 >= 1
        t0 = _counter("compile.traces")
        again = eng2.submit(job()).result(timeout=300)
        assert _counter("compile.traces") - t0 == 0
    finally:
        eng2.close(timeout=60)
    np.testing.assert_array_equal(first.result["chi2"],
                                  again.result["chi2"])


# -- degradation: every bad ledger is a clean cold boot --------------------
@pytest.mark.parametrize("payload", [
    "{ not json at all",
    json.dumps({"version": wlmod.LEDGER_VERSION + "-x", "entries": {}}),
    json.dumps({"version": wlmod.LEDGER_VERSION,
                "entries": {"x": {"not": "an entry"}}}),
])
def test_bad_ledger_degrades_to_cold_boot(tmp_path, pulsars, payload):
    lp = str(tmp_path / "warm-ledger.json")
    with open(lp, "w") as f:
        f.write(payload)
    s0 = _counter("serve.warm.stale")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        assert _counter("serve.warm.stale") - s0 == 1
        # cold but healthy: traffic serves, and the write-through then
        # REPLACES the bad ledger with a good one
        par, toas = pulsars[0]
        res = eng.submit(ResidualsRequest(par=par, toas=toas)
                         ).result(timeout=300)
        assert res.ntoa == len(toas["freq_mhz"])
    finally:
        eng.close(timeout=60)
    with open(lp) as f:
        assert json.load(f)["version"] == wlmod.LEDGER_VERSION


def test_bad_sidecar_skips_entry_never_crashes(tmp_path, pulsars):
    lp = str(tmp_path / "warm-ledger.json")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        _drive(eng, pulsars)
    finally:
        eng.close(timeout=60)
    with open(lp) as f:
        (entry,) = json.load(f)["entries"].values()
    with open(tmp_path / entry["sidecar"], "wb") as f:
        f.write(b"\x00corrupt, not a pickle")
    f0 = _counter("serve.warm.failed")
    rep0 = _counter("serve.warm.replayed")
    eng2 = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        assert _counter("serve.warm.failed") - f0 >= 1
        assert _counter("serve.warm.replayed") - rep0 == 0
        par, toas = pulsars[0]
        eng2.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=300)
    finally:
        eng2.close(timeout=60)


@pytest.mark.parametrize("corrupt", [
    "truncated-index", "sidecar-version", "sidecar-unpicklable",
])
def test_corruption_battery_cold_boots_clean(tmp_path, pulsars, corrupt):
    """Each corruption a fleet can meet on disk — a TRUNCATED index, a
    version-stale sidecar, an unpicklable sidecar — is a clean cold boot:
    counted, nothing replayed, nothing raised, traffic served."""
    lp = str(tmp_path / "warm-ledger.json")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        _drive(eng, pulsars)
    finally:
        eng.close(timeout=60)
    with open(lp) as f:
        (entry,) = json.load(f)["entries"].values()
    if corrupt == "truncated-index":
        with open(lp) as f:
            raw = f.read()
        with open(lp, "w") as f:
            f.write(raw[: int(len(raw) * 0.6)])  # a cut mid-entry
        counter = "serve.warm.stale"
    elif corrupt == "sidecar-version":
        side = tmp_path / entry["sidecar"]
        with open(side, "rb") as f:
            payload = pickle.load(f)
        payload["version"] = wlmod.LEDGER_VERSION + "-x"
        with open(side, "wb") as f:
            pickle.dump(payload, f)
        counter = "serve.warm.failed"
    else:  # a valid pickle stream naming a module that does not exist
        with open(tmp_path / entry["sidecar"], "wb") as f:
            f.write(b"cnot_a_real_module_xyz\nBogus\n.")
        counter = "serve.warm.failed"
    c0 = _counter(counter)
    rep0 = _counter("serve.warm.replayed")
    eng2 = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        assert _counter(counter) - c0 >= 1
        assert _counter("serve.warm.replayed") - rep0 == 0
        par, toas = pulsars[0]
        res = eng2.submit(ResidualsRequest(par=par, toas=toas)
                          ).result(timeout=300)
        assert res.ntoa == len(toas["freq_mhz"])
    finally:
        eng2.close(timeout=60)


# -- the port's departure: separate ledgers ------------------------------
def test_neither_package_loads_the_others_ledger(shared):
    """The reference booted on the port's ledger as a stale cold boot
    (nothing replayed), and the port boots on the reference's ledger the
    same way; the two ledgers' version tags and sidecar names differ, and
    their default paths too."""
    pulsars, ref, port_ledger, ref_ledger = shared
    assert ref["__meta__"]["stale"] == 1
    assert ref["__meta__"]["replayed"] == 0
    with open(ref_ledger) as f:
        rdoc = json.load(f)
    with open(port_ledger) as f:
        pdoc = json.load(f)
    assert rdoc["version"] != pdoc["version"] == wlmod.LEDGER_VERSION
    rside = {e["sidecar"] for e in rdoc["entries"].values()}
    pside = {e["sidecar"] for e in pdoc["entries"].values()}
    assert rside and pside and not rside & pside
    s0 = _counter("serve.warm.stale")
    rep0 = _counter("serve.warm.replayed")
    eng = TimingEngine(warm_ledger=ref_ledger, **ENGINE_KW)
    try:
        assert _counter("serve.warm.stale") - s0 == 1
        assert _counter("serve.warm.replayed") - rep0 == 0
        # a reference sidecar named in a port-tagged index is refused too
        (entry,) = rdoc["entries"].values()
        with pytest.raises(Exception):
            wlmod.WarmLedger(ref_ledger).load_sidecar(entry)
        par, toas = pulsars[0]
        eng.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=300)
    finally:
        eng.close(timeout=60)
    assert wlmod.DEFAULT_NAME != "serve-warm-ledger.json"


def test_sidecar_holds_host_arrays(tmp_path, pulsars):
    """The sidecar is the padded prototype bundle as host numpy arrays
    (its TZR row included), never device tensors."""
    lp = str(tmp_path / "warm-ledger.json")
    eng = TimingEngine(warm_ledger=lp, **ENGINE_KW)
    try:
        _drive(eng, pulsars)
    finally:
        eng.close(timeout=60)
    with open(lp) as f:
        (entry,) = json.load(f)["entries"].values()
    with open(tmp_path / entry["sidecar"], "rb") as f:
        payload = pickle.load(f)
    from pint_tpu_torch.serve.batcher import tree_leaves

    leaves = tree_leaves(payload["bundle"])
    assert leaves and all(isinstance(a, np.ndarray) for a in leaves)
    assert not any(isinstance(a, torch.Tensor) for a in leaves)
    assert payload["bundle"].ntoa == entry["bucket"]


# -- enablement ------------------------------------------------------------
def test_ledger_path_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("PINT_TPU_SERVE_WARM_LEDGER", raising=False)
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    assert wlmod.ledger_path(False) is None
    assert wlmod.ledger_path(None) is None  # env unset
    for off in ("0", "off", "no", "false", ""):
        assert wlmod.ledger_path(off) is None
    p = str(tmp_path / "l.json")
    assert wlmod.ledger_path(p) == p
    dflt = wlmod.ledger_path(True)
    assert dflt == str(tmp_path / "cache" / wlmod.DEFAULT_NAME)
    # the env enables when the keyword is unset; the keyword beats it
    monkeypatch.setenv("PINT_TPU_SERVE_WARM_LEDGER", p)
    assert wlmod.ledger_path(None) == p
    assert wlmod.ledger_path(False) is None


def test_disabled_engine_registers_nothing(tmp_path, pulsars,
                                           monkeypatch):
    monkeypatch.delenv("PINT_TPU_SERVE_WARM_LEDGER", raising=False)
    rec0 = _counter("serve.warm.recorded")
    eng = TimingEngine(warm_ledger=False, **ENGINE_KW)
    try:
        assert eng._ledger is None
        par, toas = pulsars[0]
        eng.submit(ResidualsRequest(par=par, toas=toas)).result(
            timeout=300)
    finally:
        eng.close(timeout=60)
    assert _counter("serve.warm.recorded") == rec0
    assert list(tmp_path.iterdir()) == []


# -- write-through safety --------------------------------------------------
def test_note_warm_never_raises_into_dispatch():
    """A broken ledger (unwritable path, malformed session) costs warm
    state and a ``serve.warm.failed`` tick — never a dispatch."""
    led = wlmod.WarmLedger(os.path.join(os.sep, "proc", "nonexistent",
                                        "nope", "ledger.json"))
    wlmod.register(led)
    f0 = _counter("serve.warm.failed")
    try:
        class _Sess:
            cid = "deadbeef"
            founder_par = "PSR FAKE"

            class cm:  # no bundle: the sidecar write fails
                pass

        wlmod.note_warm(
            _Sess(), ("residuals", "deadbeef", 64, True), 1, "r0"
        )
    finally:
        wlmod.unregister(led)
    assert _counter("serve.warm.failed") - f0 == 1


def test_ledger_lru_bounds_entries(tmp_path):
    """The entry LRU caps the boot replay at MAX_ENTRIES."""
    led = wlmod.WarmLedger(str(tmp_path / "l.json"))

    class _Sess:
        def __init__(self, cid):
            self.cid = cid
            self.founder_par = f"PSR {cid}"

            class _CM:
                bundle = {"x": torch.ones(1)}

            self.cm = _CM()

    for i in range(wlmod.MAX_ENTRIES + 5):
        led.record(
            _Sess(f"c{i:03d}"), ("residuals", f"c{i:03d}", 64, True),
            1, "r0",
        )
    entries = led.load()
    assert len(entries) == wlmod.MAX_ENTRIES
    cids = {e["cid"] for e in entries}
    assert "c000" not in cids
    assert f"c{wlmod.MAX_ENTRIES + 4:03d}" in cids
