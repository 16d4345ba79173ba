"""The port's background compute class (``pint_tpu_torch/serve/jobs``)
against the reference's, on the CPU.

Port twins of ``tests/test_serve_jobs.py``: grid_chisq and mcmc jobs
through ``TimingEngine.submit`` — the grid surface at the host
``gridutils.grid_chisq``'s (roundoff: the quantum program batches the
points the host path evaluates in one chunk) and the mcmc chain BITWISE
the port's own ``run_ensemble`` with the same arguments (one
``make_stretch_step`` and one step-seed plan); a steady repeat builds no
program; SLO pressure (an expired interactive deadline) preempts the
running job and it resumes to the unpressured surface bitwise; typed
admission sheds; kill and restart: an engine closed mid-job checkpoints
(the shutdown error names the file), a new engine resumes from it, and
the resumed chain is bitwise an uninterrupted job's; the stage vector and
``stats()["jobs"]``; the checkpoint satellites.  One reference
subprocess runs the same grid and mcmc jobs through the JAX engine on
the same par and TOAs: the grid surface is held to the reference's, and
the reference mcmc job's initial ensemble and step draws, fed through
the port's ``run_ensemble(draws=)`` (the two packages draw from
different generators), give the reference job's chain.  The MCMC runs are shorter than the reference test's 4096 steps (the
port's stretch step on the CPU is one eager program call a step).  The
case that needs the card (a quantum preempted on the card) is marked
``gpu``.  Every wait is bounded.
"""

import os
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.checkpoint import load_job, save_job  # noqa: E402
from pint_tpu_torch.exceptions import (  # noqa: E402
    CheckpointError,
    RequestRejected,
)
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.serve import ResidualsRequest, TimingEngine  # noqa: E402
from pint_tpu_torch.serve.api import JobRequest  # noqa: E402

PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
"""

F0, F1 = 245.4261196898081, -5.38e-16

_REF_SCRIPT = """
import os
from pint_tpu.serve import TimingEngine
from pint_tpu.serve.api import JobRequest
from pint_tpu.simulation import make_test_pulsar

m, t = make_test_pulsar(PAR, ntoa=64, start_mjd=54000.0,
                        end_mjd=56500.0, seed=33, iterations=1)
export_state(m.compile(t), "p")
META["par"] = m.as_parfile()
os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = "64"
with TimingEngine(max_batch=2, max_wait_ms=2.0, inflight=1) as eng:
    g = eng.submit(JobRequest(par=m.as_parfile(), toas=t,
                              kind="grid_chisq", grid=GRID)
                   ).result(timeout=600)
    OUT["grid/chi2"] = g.result["chi2"]
    mc = eng.submit(JobRequest(par=m.as_parfile(), toas=t, kind="mcmc",
                               nsteps=32, nwalkers=8, seed=9)
                    ).result(timeout=600)
    OUT["mcmc/chain"] = mc.result["chain"]
    OUT["mcmc/lnp"] = mc.result["lnp"]
    OUT["mcmc/acceptance"] = np.array(mc.result["acceptance"])

# the mcmc job's initial ensemble and its step draws, as the job's runner
# plans them (serve/jobs/runner.py::McmcRunner) and its stretch step
# splits each step key (sampler.make_stretch_step)
import jax
from pint_tpu.sampler import ensemble_init, ensemble_keys

req = JobRequest(par=m.as_parfile(), toas=t, kind="mcmc", nsteps=32,
                 nwalkers=8, seed=9)
walkers, key = ensemble_init(
    np.zeros(m.compile(t).nfree), nwalkers=8, seed=9,
    init_scale=req.init_scale, init_cov=req.init_cov,
    init_walkers=req.init_walkers)
draws = []
for k in ensemble_keys(key, 32):
    ks = jax.random.split(k, 6)
    for h in (0, 3):
        draws.append(np.asarray(jax.random.uniform(ks[h], (4,))))
        draws.append(np.asarray(jax.random.randint(ks[h + 1], (4,), 0, 4)))
        draws.append(np.asarray(jax.random.uniform(ks[h + 2], (4,))))
OUT["mcmc/walkers0"] = np.asarray(walkers)
OUT["mcmc/u"] = np.stack(draws[0::3])
OUT["mcmc/j"] = np.stack(draws[1::3])
OUT["mcmc/acc_u"] = np.stack(draws[2::3])
"""


def _grid(per, three=False):
    """A per**2 (or per**3) grid about the par values — fixed spacing."""
    axes = {
        "F0": list(F0 + 2e-9 * np.linspace(-1.0, 1.0, per)),
        "F1": list(F1 + 5e-18 * np.linspace(-1.0, 1.0, per)),
    }
    if three:
        axes["DM"] = list(3.1380 + 1e-5 * np.linspace(-1.0, 1.0, per))
    return axes


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_serve_jobs")
    script = (f"PAR = {PAR!r}\nGRID = {_grid(5)!r}\n"
              + textwrap.dedent(_REF_SCRIPT))
    return run_reference(script, work / "ref.npz")


@pytest.fixture(scope="module")
def pulsar(ref):
    """(model, table): ntoa = 64 — exactly the minimum bucket, so the
    host and job paths see the same (pad-free) TOA arrays."""
    from pint_tpu_torch.models.builder import get_model

    par = ref["__meta__"]["par"]
    return get_model(par), load_state(ref, "p")["bundle"]


def _mc(name):
    return obs_metrics.counter(name).value


def _wait_for(cond, timeout=60.0, tick=0.002):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(tick)
    return cond()


def _engine(quantum="64", **kw):
    """A CPU engine whose job quantum is read from the environment when
    its scheduler is built."""
    os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = quantum
    try:
        return TimingEngine(device="cpu", max_batch=2, max_wait_ms=2.0,
                            inflight=1, **kw)
    finally:
        del os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"]


@pytest.fixture(scope="module")
def engine(pulsar):
    m, toas = pulsar
    eng = _engine()
    # the interactive residuals path, warm (the preempt case's pressure
    # probe rides it)
    eng.submit(ResidualsRequest(par=m.as_parfile(), toas=toas)
               ).result(timeout=600)
    yield eng
    eng.close(timeout=60)


def _job(m, toas, **kw):
    return JobRequest(par=m.as_parfile(), toas=toas, **kw)


# -- end-to-end parity ------------------------------------------------------
def test_grid_job_matches_host_grid_chisq(engine, pulsar, ref):
    from pint_tpu_torch.gridutils import grid_chisq

    m, toas = pulsar
    grid = _grid(5)
    host = np.asarray(grid_chisq(toas, m, grid, device="cpu"))
    resp = engine.submit(_job(m, toas, kind="grid_chisq", grid=grid)
                         ).result(timeout=600)
    assert resp.kind == "grid_chisq"
    assert resp.result["names"] == ("F0", "F1")
    assert resp.result["chi2"].shape == host.shape == (5, 5)
    assert np.allclose(resp.result["chi2"], host, rtol=1e-10, atol=0.0)
    assert resp.quanta >= 1 and resp.ntoa == 64 and resp.bucket == 64
    # the JAX engine's grid job on the same par and TOAs
    np.testing.assert_allclose(resp.result["chi2"], ref["grid/chi2"],
                               rtol=1e-8)


def test_mcmc_job_bitwise_matches_host_run_ensemble(engine, pulsar, ref):
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.sampler import run_ensemble

    m, toas = pulsar
    resp = engine.submit(_job(m, toas, kind="mcmc", nsteps=128,
                              nwalkers=8, seed=9)).result(timeout=600)
    bt = BayesianTiming(m, toas, device="cpu")
    chain, lnp, acc = run_ensemble(
        bt.lnposterior, np.zeros(bt.nparams), nwalkers=8, nsteps=128,
        seed=9, device="cpu",
    )
    # one source of truth for the proposal math (make_stretch_step) and
    # the step-seed plan (ensemble_keys): the sliced quantum path is
    # bitwise the monolithic run
    assert np.array_equal(resp.result["chain"], chain)
    assert np.array_equal(resp.result["lnp"], lnp)
    assert resp.result["acceptance"] == pytest.approx(acc)
    assert resp.quanta >= 3  # the mcmc0 seed quantum + 2 step quanta


def test_mcmc_job_fed_reference_draws_matches_reference_job(engine, pulsar,
                                                            ref):
    """The reference mcmc job's initial ensemble and step draws fed
    through the port's ``run_ensemble(draws=)`` on the job's posterior
    (bitwise the port's job, above), 32 steps of 8 walkers: the chain
    within 1e-12 relative of the JAX job's and the same acceptance.

    The walkers agree to the last bit but for an ulp here and there: the
    reference's CPU build rounds the stretch proposal ``o + z * (m - o)``
    once (a fused multiply-add), the port twice.  Far from the mode (the
    default 1e-8 ball, log-posteriors near -4e7) one ulp of a walker
    moves its log-posterior by up to ~5e-8 relative, so the
    log-posteriors are held where the walkers are bitwise equal, and the
    port's posterior is held to the reference job's at every point of
    the reference's chain."""
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.sampler import run_ensemble

    m, toas = pulsar
    u, j, a = ref["mcmc/u"], ref["mcmc/j"], ref["mcmc/acc_u"]
    draws = [(u[2 * s], j[2 * s], a[2 * s], u[2 * s + 1], j[2 * s + 1],
              a[2 * s + 1]) for s in range(32)]
    bt = BayesianTiming(m, toas, device="cpu")
    chain, lnp, acc = run_ensemble(
        bt.lnposterior, np.zeros(bt.nparams), nwalkers=8, nsteps=32,
        init_walkers=ref["mcmc/walkers0"], draws=draws, device="cpu",
    )
    rc, rl = ref["mcmc/chain"], ref["mcmc/lnp"]
    np.testing.assert_allclose(chain, rc, rtol=1e-12, atol=0)
    assert acc == pytest.approx(float(ref["mcmc/acceptance"]), rel=1e-12)
    assert 0.0 < acc < 1.0
    same = np.all(chain == rc, axis=-1)
    assert same[0].sum() >= 4  # step 0: at least the unmoved half
    np.testing.assert_allclose(lnp[same], rl[same], rtol=1e-12, atol=0)
    at_ref = torch.func.vmap(bt.lnposterior)(
        torch.as_tensor(rc.reshape(-1, rc.shape[-1]))).numpy()
    np.testing.assert_allclose(at_ref.reshape(rl.shape), rl, rtol=1e-12,
                               atol=0)


def test_steady_repeat_zero_builds_bitwise(engine, pulsar):
    m, toas = pulsar
    grid = _grid(6)

    def req():
        return _job(m, toas, kind="grid_chisq", grid=grid)

    first = engine.submit(req()).result(timeout=600)
    tr0 = _mc("compile.traces")
    again = engine.submit(req()).result(timeout=600)
    assert _mc("compile.traces") - tr0 == 0
    assert np.array_equal(first.result["chi2"], again.result["chi2"])


# -- preemption -------------------------------------------------------------
def test_preempt_resume_on_slo_pressure(engine, pulsar):
    m, toas = pulsar
    grid = _grid(8, three=True)  # 512 points = 8 quanta at q = 64
    unpressured = engine.submit(_job(m, toas, kind="grid_chisq",
                                     grid=grid)).result(timeout=600)
    p0, r0 = _mc("serve.jobs.preempted"), _mc("serve.jobs.resumed")
    q0 = _mc("serve.jobs.quanta")
    fut = engine.submit(_job(m, toas, kind="grid_chisq", grid=grid))
    assert _wait_for(lambda: _mc("serve.jobs.quanta") > q0)
    # a deliberately expired interactive deadline fires the shed signal
    # the scheduler watches — deterministic pressure
    with pytest.raises(RequestRejected) as ei:
        engine.submit(ResidualsRequest(
            par=m.as_parfile(), toas=toas, deadline_s=1e-4,
        )).result(timeout=600)
    assert ei.value.reason == "deadline"
    resp = fut.result(timeout=600)
    assert _mc("serve.jobs.preempted") - p0 >= 1
    assert _mc("serve.jobs.resumed") - r0 >= 1
    assert resp.preemptions >= 1
    assert np.array_equal(unpressured.result["chi2"], resp.result["chi2"])


# -- typed admission sheds --------------------------------------------------
def test_jobs_disabled_typed_rejection(pulsar):
    m, toas = pulsar
    os.environ["PINT_TPU_SERVE_JOBS"] = "0"
    try:
        eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=2.0,
                           inflight=1)
    finally:
        del os.environ["PINT_TPU_SERVE_JOBS"]
    try:
        with pytest.raises(RequestRejected) as ei:
            eng.submit(_job(m, toas, kind="grid_chisq", grid=_grid(3))
                       ).result(timeout=60)
        assert ei.value.reason == "jobs-disabled"
    finally:
        eng.close(timeout=60)


def test_jobs_queue_full_typed_rejection(pulsar):
    m, toas = pulsar
    eng = TimingEngine(device="cpu", max_batch=2, max_wait_ms=2.0,
                       inflight=1)
    try:
        # park the scheduler: a finished thread keeps _loop from
        # starting, so the queue fills deterministically
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        eng._jobs._thread = dead
        eng._jobs.max_queue = 1
        held = eng.submit(_job(m, toas, kind="grid_chisq", grid=_grid(3)))
        with pytest.raises(RequestRejected) as ei:
            eng.submit(_job(m, toas, kind="grid_chisq", grid=_grid(3))
                       ).result(timeout=60)
        assert ei.value.reason == "jobs-queue-full"
        assert not held.done()
    finally:
        eng.close(timeout=60)
    # close() sheds the parked job typed, never silently drops it
    with pytest.raises(RequestRejected) as ei:
        held.result(timeout=1.0)
    assert ei.value.reason == "shutdown"


# -- kill-and-restart resume ------------------------------------------------
def test_kill_mid_job_checkpoint_resume_bitwise(pulsar, tmp_path):
    m, toas = pulsar
    cp = str(tmp_path / "mcmc-job.npz")

    def job_req(checkpoint=True):
        return _job(m, toas, kind="mcmc", nsteps=128, nwalkers=8, seed=77,
                    checkpoint_path=cp if checkpoint else None)

    eng = _engine("8")
    q0 = _mc("serve.jobs.quanta")
    fut = eng.submit(job_req())
    # 16 quanta of runway: close() lands mid-chain
    assert _wait_for(lambda: _mc("serve.jobs.quanta") - q0 >= 3)
    eng.close(timeout=60)
    with pytest.raises(RequestRejected) as ei:
        fut.result(timeout=1.0)
    assert ei.value.reason == "shutdown"
    assert cp in str(ei.value)  # the shed names the checkpoint
    saved = load_job(cp)
    assert 0 < int(saved["cursor"]) < 128

    eng2 = _engine("8")
    try:
        resumed = eng2.submit(job_req()).result(timeout=600)
        whole = eng2.submit(job_req(checkpoint=False)).result(timeout=600)
    finally:
        eng2.close(timeout=60)
    assert resumed.resumed and not whole.resumed
    assert resumed.result["chain"].shape[0] == 128
    # resume loses nothing: bitwise the uninterrupted run
    assert np.array_equal(resumed.result["chain"], whole.result["chain"])
    assert np.array_equal(resumed.result["lnp"], whole.result["lnp"])


# -- observability ----------------------------------------------------------
def test_job_stage_vector_monotonic(engine, pulsar):
    from pint_tpu_torch.obs.metrics import STAGES

    m, toas = pulsar
    resp = engine.submit(_job(m, toas, kind="grid_chisq", grid=_grid(3))
                         ).result(timeout=600)
    assert "submit" in resp.stages and "finish" in resp.stages
    seen = [resp.stages[s] for s in STAGES if s in resp.stages]
    assert len(seen) >= 3
    assert all(b >= a for a, b in zip(seen, seen[1:]))


def test_stats_jobs_block(engine):
    st = engine.stats()["jobs"]
    for k in (
        "enabled", "running", "queued", "submitted", "completed",
        "rejected", "quanta", "preemptions", "resumes", "checkpoints",
        "restores", "faults", "kernels", "quantum_p50_ms",
        "quantum_p99_ms",
    ):
        assert k in st, k
    assert st["enabled"] and st["submitted"] >= 1
    assert st["completed"] >= 1 and st["quanta"] >= 1


# -- checkpoint satellites --------------------------------------------------
def test_save_job_roundtrip_including_object_payload(tmp_path):
    p = str(tmp_path / "job.npz")
    state = {"cursor": 7, "chi2": np.arange(9.0),
             "rng": {"bits": [1, 2, 3], "pos": 4}}
    save_job(p, state)
    out = load_job(p)
    assert int(out["cursor"]) == 7
    assert np.array_equal(out["chi2"], np.arange(9.0))
    assert out["rng"] == {"bits": [1, 2, 3], "pos": 4}


def test_save_job_refuses_reserved_fields(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        save_job(str(tmp_path / "job.npz"), {"version": 2})
    with pytest.raises(ValueError, match="reserved"):
        save_job(str(tmp_path / "job.npz"), {"kind": "grid"})


def test_atomic_write_keeps_old_file_on_failure(tmp_path, monkeypatch):
    p = str(tmp_path / "job.npz")
    save_job(p, {"cursor": 1})

    def boom(*a, **kw):
        raise OSError("disk pulled")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        save_job(p, {"cursor": 2})
    monkeypatch.undo()
    # the torn write never reached the live file, and no tmp litter
    assert int(load_job(p)["cursor"]) == 1
    assert os.listdir(str(tmp_path)) == ["job.npz"]


def test_truncated_checkpoint_is_typed_error(tmp_path):
    p = str(tmp_path / "job.npz")
    save_job(p, {"cursor": 3, "chi2": np.arange(64.0)})
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        load_job(p)


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_card_mcmc_quantum_preempted_resumes_bitwise():
    """On the card: an MCMC job preempted by an expired interactive
    deadline mid-run resumes to a chain bitwise the port's own
    ``run_ensemble`` on the same seed and device."""
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.sampler import run_ensemble
    from pint_tpu_torch.simulation import make_test_pulsar

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    m, toas = make_test_pulsar(PAR, ntoa=64, start_mjd=54000.0,
                               end_mjd=56500.0, seed=33, iterations=1,
                               device="cpu")
    os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"] = "8"
    try:
        eng = TimingEngine(device="cuda", max_batch=2, max_wait_ms=2.0,
                           inflight=1)
    finally:
        del os.environ["PINT_TPU_SERVE_JOBS_QUANTUM"]
    with eng:
        eng.submit(ResidualsRequest(par=m.as_parfile(), toas=toas)
                   ).result(timeout=600)
        q0 = _mc("serve.jobs.quanta")
        fut = eng.submit(_job(m, toas, kind="mcmc", nsteps=256,
                              nwalkers=16, seed=4))
        assert _wait_for(lambda: _mc("serve.jobs.quanta") > q0 + 1,
                         timeout=300)
        with pytest.raises(RequestRejected):
            eng.submit(ResidualsRequest(par=m.as_parfile(), toas=toas,
                                        deadline_s=1e-4)
                       ).result(timeout=600)
        resp = fut.result(timeout=600)
    assert resp.preemptions >= 1
    bt = BayesianTiming(m, toas, device="cuda")
    chain, lnp, _ = run_ensemble(bt.lnposterior, np.zeros(bt.nparams),
                                 nwalkers=16, nsteps=256, seed=4,
                                 device="cuda")
    assert np.array_equal(resp.result["chain"], chain)
    assert np.array_equal(resp.result["lnp"], lnp)
