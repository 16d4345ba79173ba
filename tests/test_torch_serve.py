"""The port's serving engine (``pint_tpu_torch/serve``) against the
reference's, on the CPU.

Port twins of ``tests/test_serve.py``: the bucket and capacity policies,
the composition-keyed session cache, residuals/fit/predict parity (each
served result against the direct computation, as the reference's tests
hold it, and against the JAX engine's response on the same pars and
TOAs), no program build across mixed sizes in a bucket, the WLS refusal,
typed deadline shedding, stalls that shed and never hang, rejection after
close.  Port-only cases: the engine defaults to the card and raises
without one, refuses what is not ported (gangs and the elastic
repartitioner, the multi-card half of the fleet) naming its ROADMAP
label, serves the one-card half (jobs, appends, streams, the warm ledger),
and ``pint_tpu_torch.serve`` imports neither JAX nor the JAX package.  One reference subprocess builds the
pulsars, serves them through the JAX engine and exports the TOA tables
and responses.  Every wait is bounded.
"""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import REPO, load_state, run_reference  # noqa: E402

from pint_tpu_torch.exceptions import (  # noqa: E402
    GuardTimeout,
    PintTpuError,
    RequestRejected,
    RetriesExhausted,
)
from pint_tpu_torch.fitting.gls import GLSFitter  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.runtime import faults, guard  # noqa: E402
from pint_tpu_torch.serve import (  # noqa: E402
    AppendRequest,
    FitRequest,
    JobRequest,
    PredictRequest,
    ResidualsRequest,
    TimingEngine,
    shape_bucket,
)
from pint_tpu_torch.serve.batcher import capacity_for  # noqa: E402
from pint_tpu_torch.serve.session import SessionCache  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402
from pint_tpu_torch.toas.bundle import take_rows  # noqa: E402

PAR = """
PSR              J0000+00{i:02d}
F0               {f0}  1
F1               -1.1e-15           1
PEPOCH           55000
DM               {dm}             1
"""
#: (i, f0, dm, ntoa, seed): three same-composition pulsars of mixed TOA
#: counts in the 64 bucket, and the fresh par of the retrace gate
PULSARS = [(0, 101.1, 10.0, 40, 1), (1, 215.9, 22.0, 50, 2),
           (2, 88.3, 5.5, 60, 3)]
FRESH = (9, 77.7, 3.3, 45, 9)
MJDS = [55000.001 + 0.0045 * k for k in range(7)]

_REF_SCRIPT = """
from pint_tpu.serve import (
    FitRequest, PredictRequest, ResidualsRequest, TimingEngine,
)
from pint_tpu.simulation import make_test_pulsar

pulsars = []
for j, (i, f0, dm, n, seed) in enumerate(PULSARS + [FRESH]):
    m, t = make_test_pulsar(PAR.format(i=i, f0=f0, dm=dm), ntoa=n,
                            seed=seed, iterations=1)
    export_state(m.compile(t), f"p{j}")
    pulsars.append((m.as_parfile(), t))
META["pars"] = [p for p, _ in pulsars]
live = pulsars[:3]
with TimingEngine(max_batch=4, max_wait_ms=2.0, inflight=2) as eng:
    res = [f.result(timeout=300) for f in eng.submit_many(
        [ResidualsRequest(par=p, toas=t) for p, t in live])]
    fits = [f.result(timeout=300) for f in eng.submit_many(
        [FitRequest(par=p, toas=t, maxiter=3) for p, t in live])]
    pred = eng.submit(PredictRequest(
        par=live[0][0], mjds=np.array(MJDS))).result(timeout=300)
for j, (r, f) in enumerate(zip(res, fits)):
    OUT[f"res{j}"] = r.residuals_s
    OUT[f"res{j}/chi2"] = np.array(r.chi2)
    OUT[f"res{j}/batch"] = np.array(r.batch_size)
    OUT[f"fit{j}/deltas"] = f.deltas
    OUT[f"fit{j}/unc"] = f.uncertainties
    OUT[f"fit{j}/chi2"] = np.array(f.chi2)
    OUT[f"fit{j}/converged"] = np.array(f.converged)
    META[f"fit{j}/names"] = list(f.names)
OUT["pred/int"] = np.asarray(pred.phase_int)
OUT["pred/frac"] = np.asarray(pred.phase_frac)
OUT["pred/freq"] = np.asarray(pred.spin_freq_hz)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_serve")
    script = (f"PAR = {PAR!r}\nPULSARS = {PULSARS!r}\nFRESH = {FRESH!r}\n"
              f"MJDS = {MJDS!r}\n" + textwrap.dedent(_REF_SCRIPT))
    return run_reference(script, work / "ref.npz")


def _pulsar(ref, j):
    """(par text, TOA table) of the reference's pulsar ``j``."""
    return ref["__meta__"]["pars"][j], load_state(ref, f"p{j}")["bundle"]


@pytest.fixture(scope="module")
def pulsars(ref):
    return [_pulsar(ref, j) for j in range(3)]


@pytest.fixture(scope="module")
def engine():
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=2.0,
                       inflight=2)
    yield eng
    eng.close(timeout=60)


# -- bucket / capacity policy --------------------------------------------
def test_shape_bucket_policy():
    assert shape_bucket(1) == 64  # MIN_BUCKET floor
    assert shape_bucket(64) == 64
    assert shape_bucket(65) == 128
    assert shape_bucket(300) == 512
    assert shape_bucket(40, min_bucket=16) == 64
    with pytest.raises(PintTpuError):
        shape_bucket(0)


def test_capacity_policy():
    assert capacity_for(1, 16) == 1
    assert capacity_for(3, 16) == 4
    assert capacity_for(5, 4) == 4  # capped at max_batch
    assert capacity_for(16, 16) == 16


# -- session cache --------------------------------------------------------
def test_session_cache_composition_keyed_lru(pulsars):
    """Distinct pars of one composition share ONE session; par records
    LRU-evict independently of the session."""
    cache = SessionCache(max_sessions=4, max_pars=2, device="cpu")
    pev0 = obs_metrics.counter("serve.session.par_evictions").value
    sessions = [cache.get_or_create(par, toas) for par, toas in pulsars]
    assert sessions[0] is sessions[1] is sessions[2]
    assert len(cache) == 1
    assert sessions[0].composition == sessions[1].composition
    assert cache.npars == 2
    assert (obs_metrics.counter("serve.session.par_evictions").value - pev0
            == 1)
    # re-admitting the evicted par is a host parse riding the SAME
    # session (a session-layer hit, a par-layer miss)
    h0 = obs_metrics.counter("serve.session.hits").value
    pm0 = obs_metrics.counter("serve.session.par_misses").value
    again = cache.get_or_create(pulsars[0][0], pulsars[0][1])
    assert again is sessions[0]
    assert obs_metrics.counter("serve.session.hits").value == h0 + 1
    assert obs_metrics.counter("serve.session.par_misses").value == pm0 + 1
    ph0 = obs_metrics.counter("serve.session.par_hits").value
    cache.get_or_create(pulsars[2][0], pulsars[2][1])
    assert obs_metrics.counter("serve.session.par_hits").value == ph0 + 1


def test_host_state_and_tracking_split_compositions(pulsars):
    """The port's key folds in the tracking mode and the components'
    host state: the same par over TOAs with pulse numbers is a
    composition of its own (PTABatch would refuse to stack the two)."""
    cache = SessionCache(device="cpu")
    par, toas = pulsars[0]
    numbered = dict(toas, pulse_number=np.arange(len(toas["freq_mhz"]),
                                                 dtype=np.float64))
    a = cache.get_or_create(par, toas)
    b = cache.get_or_create(par, numbered)
    assert a is not b and a.composition != b.composition
    assert a.cm.track_mode == "nearest"
    assert b.cm.track_mode == "use_pulse_numbers"
    # ... and the components' host state: a glitch with a decay term
    # shapes its kernel, so pars with and without one do not stack
    glitch = "GLEP_1 55000\nGLPH_1 0\nGLF0_1 1e-8\nGLF0D_1 1e-9\nGLTD_1 {}\n"
    c = cache.get_or_create(par + glitch.format(0), toas)
    d = cache.get_or_create(par + glitch.format(50), toas)
    e = cache.get_or_create(par + glitch.format(80), toas)
    assert c is not d and c.composition != d.composition
    assert d is e  # the decay's value is data; whether there is one is not


# -- parity + no builds ----------------------------------------------------
def test_residuals_parity_and_batching(engine, pulsars, ref):
    futs = [engine.submit(ResidualsRequest(par=p, toas=t))
            for p, t in pulsars]
    for j, ((par, toas), fut) in enumerate(zip(pulsars, futs)):
        resp = fut.result(timeout=120)
        assert resp.ntoa == len(toas["freq_mhz"])
        assert resp.bucket == 64
        assert resp.batch_size == 3  # all three stacked in one batch
        assert resp.batch_size == int(ref[f"res{j}/batch"])
        cm = get_model(par).compile(toas, device="cpu")
        direct = cm.time_residuals(cm.x0()).numpy()
        np.testing.assert_allclose(resp.residuals_s, direct, rtol=1e-9,
                                   atol=1e-15)
        np.testing.assert_allclose(resp.residuals_s, ref[f"res{j}"],
                                   rtol=1e-9, atol=1e-15)
        assert resp.chi2 == pytest.approx(float(ref[f"res{j}/chi2"]),
                                          rel=1e-9)


def test_fit_parity_batched_vs_direct(engine, pulsars, ref):
    futs = [engine.submit(FitRequest(par=p, toas=t, maxiter=3))
            for p, t in pulsars]
    for j, ((par, toas), fut) in enumerate(zip(pulsars, futs)):
        resp = fut.result(timeout=120)
        f = GLSFitter(toas, get_model(par), device="cpu")
        f.fit_toas(maxiter=3)
        assert resp.chi2 == pytest.approx(f.chi2, rel=1e-6)
        assert resp.converged == f.converged
        fitted = get_model(resp.fitted_par)
        for n, sigma in zip(resp.names, resp.uncertainties):
            a, b = fitted.params[n].value, f.model.params[n].value
            fa = float(a.to_float()) if hasattr(a, "to_float") else float(a)
            fb = float(b.to_float()) if hasattr(b, "to_float") else float(b)
            assert abs(fa - fb) < 1e-3 * sigma + 1e-30, n
        np.testing.assert_allclose(
            resp.uncertainties,
            np.sqrt(np.diag(f.parameter_covariance_matrix)), rtol=1e-5)
        # the JAX engine's response to the same request
        assert list(resp.names) == ref["__meta__"][f"fit{j}/names"]
        assert resp.chi2 == pytest.approx(float(ref[f"fit{j}/chi2"]),
                                          rel=1e-6)
        assert resp.converged == bool(ref[f"fit{j}/converged"])
        np.testing.assert_allclose(resp.uncertainties, ref[f"fit{j}/unc"],
                                   rtol=1e-5)
        assert np.all(np.abs(resp.deltas - ref[f"fit{j}/deltas"])
                      <= 1e-3 * ref[f"fit{j}/unc"])


def test_zero_retraces_across_mixed_sizes_within_bucket(engine, pulsars,
                                                        ref):
    """Once a (composition, bucket, capacity) has served, further
    mixed-size traffic in that bucket builds NO program — measured by the
    ``compile.traces`` counter at the serve dispatch chokepoint."""
    for op in (ResidualsRequest, FitRequest):
        kw = {"maxiter": 3} if op is FitRequest else {}
        wave = 1
        while wave <= 4:
            futs = [engine.submit(op(par=p, toas=t, **kw))
                    for p, t in (pulsars * 2)[:wave]]
            [f.result(timeout=120) for f in futs]
            wave <<= 1
    traces0 = obs_metrics.counter("compile.traces").value
    # NEW sizes (and one brand-new par) inside the same 64 bucket
    mixed = [pulsars[0], _pulsar(ref, 3), pulsars[2]]
    for op in (ResidualsRequest, FitRequest):
        kw = {"maxiter": 3} if op is FitRequest else {}
        futs = [engine.submit(op(par=p, toas=t, **kw)) for p, t in mixed]
        for f in futs:
            f.result(timeout=120)
    assert obs_metrics.counter("compile.traces").value == traces0
    assert engine.stats()["batch_occupancy_mean"] is not None


def test_wls_method_refused_on_correlated_model():
    par = ("PSR J0000+0099\nF0 99.9 1\nF1 -1e-15 1\nPEPOCH 55000\n"
           "DM 7.0 1\nEFAC -f L-wide 1.1\nTNREDAMP -13.5\n"
           "TNREDGAM 3.5\nTNREDC 4\n")
    m, t = make_test_pulsar(par, ntoa=32, seed=4, iterations=1,
                            device="cpu")
    with TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0) as eng:
        fut = eng.submit(FitRequest(par=m.as_parfile(), toas=t,
                                    method="wls"))
        with pytest.raises(PintTpuError, match="correlated"):
            fut.result(timeout=60)


# -- load shedding / backpressure ----------------------------------------
def test_deadline_shed_is_typed(pulsars):
    par, toas = pulsars[0]
    with TimingEngine(device="cpu", max_batch=2, max_wait_ms=1.0) as eng:
        fut = eng.submit(ResidualsRequest(par=par, toas=toas,
                                          deadline_s=0.0))
        with pytest.raises(RequestRejected) as ei:
            fut.result(timeout=60)
        assert ei.value.reason == "deadline"


def test_stall_sheds_and_rejects_never_hangs(pulsars):
    """Injected dispatch stalls surface as typed watchdog failures while
    the bounded queue sheds overflow — bounded time, never a hang."""
    par, toas = pulsars[0]
    shed0 = obs_metrics.counter("serve.rejected").value
    with guard.configured(compile_timeout=0.3, dispatch_timeout=0.3,
                          max_retries=0):
        with faults.inject("hang:inf@serve:", hang_seconds=1.0):
            eng = TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0,
                               inflight=1, max_queue=2)
            t0 = time.monotonic()
            futs = [eng.submit(ResidualsRequest(par=par, toas=toas))
                    for _ in range(8)]
            outcomes = {"timeout": 0, "queue-full": 0, "other": 0}
            for fut in futs:
                try:
                    fut.result(timeout=60)
                    outcomes["other"] += 1  # success impossible
                except (GuardTimeout, RetriesExhausted):
                    outcomes["timeout"] += 1
                except RequestRejected as e:
                    assert e.reason == "queue-full"
                    outcomes["queue-full"] += 1
            wall = time.monotonic() - t0
            eng.close(timeout=60)
    assert outcomes["other"] == 0
    assert outcomes["timeout"] >= 1  # watchdog tripped, typed
    assert outcomes["queue-full"] >= 1  # bounded queue shed the rest
    assert wall < 30.0  # bounded, not hung
    assert obs_metrics.counter("serve.rejected").value > shed0


def test_engine_rejects_after_close(pulsars):
    par, toas = pulsars[0]
    eng = TimingEngine(device="cpu", max_batch=1, max_wait_ms=0.0)
    eng.close(timeout=60)
    fut = eng.submit(ResidualsRequest(par=par, toas=toas))
    with pytest.raises(RequestRejected) as ei:
        fut.result(timeout=10)
    assert ei.value.reason == "shutdown"


# -- polyco phase-predict -------------------------------------------------
def test_predict_parity_and_span_cache(engine, pulsars, ref):
    from pint_tpu_torch.polycos import Polycos

    par, _ = pulsars[0]
    mjds = np.array(MJDS)
    r1 = engine.submit(PredictRequest(par=par, mjds=mjds)).result(
        timeout=120)
    assert not r1.cached
    r2 = engine.submit(PredictRequest(par=par, mjds=mjds + 1e-4)).result(
        timeout=120)
    assert r2.cached
    model = get_model(par)
    span_days = 60.0 / 1440.0
    start = np.floor(mjds.min() / span_days) * span_days
    pc = Polycos.generate(model, float(start), float(mjds.max() + 1e-9),
                          segment_minutes=60.0, ncoeff=12, device="cpu")
    ints, fracs = pc.eval_abs_phase(mjds)
    np.testing.assert_allclose(r1.phase_frac, fracs, atol=1e-7)
    np.testing.assert_array_equal(r1.phase_int, ints)
    np.testing.assert_allclose(r1.spin_freq_hz, pc.eval_spin_freq(mjds),
                               rtol=1e-12)
    # the JAX engine's prediction
    np.testing.assert_array_equal(r1.phase_int, ref["pred/int"])
    np.testing.assert_allclose(r1.phase_frac, ref["pred/frac"], atol=1e-7)
    np.testing.assert_allclose(r1.spin_freq_hz, ref["pred/freq"],
                               rtol=1e-12)


# -- the port's own edges ----------------------------------------------------
def test_engine_defaults_to_the_card():
    """``TimingEngine()`` means the CUDA card, like every entry point of
    the port: without one it raises instead of serving on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TimingEngine()


@pytest.mark.parametrize("kw", [dict(gangs=2), dict(gang_size=2),
                                dict(gang_threshold=4096),
                                dict(gangs=1, gang_size=2),
                                dict(elastic=True)])
def test_unported_engine_arguments_name_a12c(kw):
    """Gang executors and the elastic repartitioner, A12c's multi-card
    half, are refused naming the ROADMAP item that ports them (A12d, the
    item after A8's meshes)."""
    with pytest.raises(PintTpuError, match="ROADMAP A12d"):
        TimingEngine(device="cpu", **kw)


def test_unported_requests_name_a12c(engine, pulsars, tmp_path):
    """What A12c's one-card half ports is no longer refused: a job, a
    stream and an append serve, and ``warm_ledger=`` keeps a ledger."""
    par, toas = pulsars[0]
    r0 = engine.submit(ResidualsRequest(par=par, toas=toas)).result(
        timeout=120)
    f0 = float(par.split("F0")[1].split()[0])
    job = engine.submit(JobRequest(
        par=par, toas=toas, grid={"F0": [f0, f0 + 1e-10]})).result(
            timeout=120)
    assert job.result["chi2"].shape == (2,)
    assert np.isfinite(job.result["chi2"]).all()
    n = r0.ntoa
    s = engine.open_stream(par, take_rows(toas, np.arange(n - 8)))
    try:
        r = s.append(take_rows(toas, np.arange(n - 8, n))).result(
            timeout=120)
        assert r.refit == "incremental" and r.ntoa == n
    finally:
        s.close()
    assert AppendRequest.op == "append"
    lp = str(tmp_path / "ledger.json")
    with TimingEngine(device="cpu", warm_ledger=lp) as eng:
        assert eng._ledger is not None and eng._ledger.path == lp


def test_serve_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
    import builtins, sys
    real = builtins.__import__
    def guard(name, *a, **k):
        if name.split(".")[0] in ("jax", "jaxlib", "pint_tpu"):
            raise ImportError(f"barred import {name}")
        return real(name, *a, **k)
    builtins.__import__ = guard
    import pint_tpu_torch.serve
    import pint_tpu_torch.serve.fabric
    import pint_tpu_torch.serve.jobs
    import pint_tpu_torch.serve.stream
    import pint_tpu_torch.serve.warm_ledger
    barred = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu")]
    print(barred)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
