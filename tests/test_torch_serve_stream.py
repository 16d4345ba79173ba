"""The port's streaming serving surface (``pint_tpu_torch/serve/stream.py``)
against the reference's, on the CPU.

Port twins of ``tests/test_serve_stream.py``, at its sizes: an
incrementally advanced stream matches the engine's cold fit on the
concatenated TOAs (white, and pure-Fourier red noise on interior,
span-preserving appends), ECORR serves every append on the warm rung,
steady appends build no program, a warm-started fit builds none, the
refresh cadence, the fallback chain (corrupted solver state, a corrupted
maintained factor, an injected dispatch fault: each lands on the warm
rung on the caller's future), the residual alert on a glitched tail, and
typed shedding.  One reference subprocess runs the same streams through
the JAX engine on the same pars and TOA tables; the port's streams are
held to its answers at the cross-package tolerances of
``tests/test_torch_serve_fabric.py``.  Departures tested here: a failed
append batch leaves the stream's state bitwise as it was, and a drift
rollback fails only its own row of a stacked append batch.  The case
that needs the card (an append's replay beside another replica's
capture) is marked ``gpu``.  Every wait is bounded.
"""

import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.exceptions import (  # noqa: E402
    PintTpuNumericsError,
    RequestRejected,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.runtime import faults, guard  # noqa: E402
from pint_tpu_torch.serve import (  # noqa: E402
    AppendRequest,
    FitRequest,
    ResidualsRequest,
    TimingEngine,
)
from pint_tpu_torch.serve.stream import (  # noqa: E402
    _noise_basis_keys,
    merge_tables,
)
from pint_tpu_torch.toas.bundle import take_rows  # noqa: E402

PAR = """
PSR              J0613-0200
F0               326.6005670880  1
F1               -1.02e-15       1
PEPOCH           55000
DM               38.779          1
"""
RED = PAR + "TNREDAMP -13.0\nTNREDGAM 3.0\nTNREDC 10\n"
ECORR = PAR + "ECORR -f L-wide 0.5\n"
#: the red pulsar's interior appends (span-preserving)
INTERIOR = (40, 80)

_REF_SCRIPT = """
from pint_tpu.serve import FitRequest, TimingEngine
from pint_tpu.simulation import make_test_pulsar
from pint_tpu.toas.toas import merge_TOAs

def pulsar(partxt, n, seed, name):
    m, t = make_test_pulsar(partxt, ntoa=n, seed=seed, iterations=1)
    export_state(m.compile(t), name)
    META[name + "_par"] = m.as_parfile()
    META[name + "_flags"] = [dict(f) for f in t.flags]
    return m.as_parfile(), t

w_par, w = pulsar(PAR, 300, 42, "white")
r_par, r = pulsar(RED, 300, 42, "red")
e_par, e = pulsar(ECORR, 200, 5, "ecorr")
idx = np.arange(300)
inter = idx[INTERIOR[0]:INTERIOR[1]]
keep = np.array(sorted(set(idx.tolist()) - set(inter.tolist())))
n_i = len(inter) // 2
cases = {
    "white": (w_par, [w[:260], w[260:280], w[280:300]]),
    "red": (r_par, [r[keep], r[inter[:n_i]], r[inter[n_i:]]]),
    "ecorr": (e_par, [e[:180], e[180:]]),
}
with TimingEngine(max_batch=4, max_wait_ms=2.0, inflight=2) as eng:
    for name, (par, parts) in cases.items():
        s = eng.open_stream(par, parts[0])
        rungs = [s.append(p).result(timeout=300).refit for p in parts[1:]]
        META[name + "_rungs"] = rungs
        OUT[name + "/deltas"] = s.deltas
        OUT[name + "/unc"] = s.uncertainties
        OUT[name + "/chi2"] = np.array(s.chi2)
        full = parts[0]
        for p in parts[1:]:
            full = merge_TOAs([full, p])
        cold = eng.submit(FitRequest(par=par, toas=full, maxiter=4)
                          ).result(timeout=300)
        OUT[name + "/cold_deltas"] = np.asarray(cold.deltas)
        OUT[name + "/cold_chi2"] = np.array(cold.chi2)
        s.close()
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_serve_stream")
    script = (f"PAR = {PAR!r}\nRED = {RED!r}\nECORR = {ECORR!r}\n"
              f"INTERIOR = {INTERIOR!r}\n" + textwrap.dedent(_REF_SCRIPT))
    return run_reference(script, work / "ref.npz")


def _pulsar(ref, name):
    """(par text, host table) of one exported pulsar: its flags carried
    across, its noise-basis columns dropped (a slice's basis is computed
    over the slice, as the reference computes it for a TOA subset)."""
    meta = ref["__meta__"]
    par = meta[name + "_par"]
    table = load_state(ref, name)["bundle"]
    table["flags"] = meta[name + "_flags"]
    drop = _noise_basis_keys(get_model(par))
    table["masks"] = {k: v for k, v in table["masks"].items()
                      if k not in drop}
    return par, table


@pytest.fixture(scope="module")
def white(ref):
    return _pulsar(ref, "white")


@pytest.fixture(scope="module")
def red(ref):
    return _pulsar(ref, "red")


@pytest.fixture(scope="module")
def engine():
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=2.0,
                       inflight=2)
    yield eng
    eng.close(timeout=60)


def _rows(t, lo, hi):
    return take_rows(t, np.arange(lo, hi))


def _parity(eng, s, parts, tol_delta=1e-6, tol_unc=1e-6, tol_chi2=1e-9):
    """A stream's committed solution against the engine's cold fit on the
    concatenated TOAs (the reference test's gate); -> the cold fit."""
    full = merge_tables(s._rec.model, parts)
    cold = eng.submit(FitRequest(par=s._rec.par, toas=full, maxiter=4)
                      ).result(timeout=300)
    unc = np.asarray(cold.uncertainties)
    assert s.names == tuple(cold.names)
    diff = np.abs(s.deltas - np.asarray(cold.deltas))
    assert np.all(diff <= tol_delta * unc), (diff / unc, tol_delta)
    np.testing.assert_allclose(s.uncertainties, unc, rtol=tol_unc)
    assert s.chi2 == pytest.approx(cold.chi2, rel=tol_chi2)
    return cold


def _at_reference(ref, name, s):
    """The port's stream at the JAX engine's stream, same pars and TOAs
    (the fabric file's cross-package tolerances)."""
    unc = ref[name + "/unc"]
    assert np.all(np.abs(s.deltas - ref[name + "/deltas"]) <= 1e-3 * unc)
    np.testing.assert_allclose(s.uncertainties, unc, rtol=1e-5)
    assert s.chi2 == pytest.approx(float(ref[name + "/chi2"]), rel=1e-6)


# -- parity ---------------------------------------------------------------
def test_white_incremental_parity(engine, white, ref):
    par, t = white
    base, t1, t2 = _rows(t, 0, 260), _rows(t, 260, 280), _rows(t, 280, 300)
    s = engine.open_stream(par, base)
    try:
        r1 = s.append(t1).result(timeout=300)
        r2 = s.append(t2).result(timeout=300)
        assert (r1.refit, r2.refit) == ("incremental", "incremental")
        assert ref["__meta__"]["white_rungs"] == [r1.refit, r2.refit]
        assert r1.state is None  # engine-internal, never caller-facing
        assert r2.ntoa == s.ntoa == 300
        assert r2.appended == 20
        _parity(engine, s, [base, t1, t2],
                tol_delta=1e-6, tol_unc=1e-9, tol_chi2=1e-9)
        _at_reference(ref, "white", s)
        # the response's provenance names the TAIL bucket
        assert r1.bucket >= 20
        assert s.fitted_par().startswith("PSR")
    finally:
        s.close()


def test_fourier_incremental_parity_span_preserving(engine, red, ref):
    """Red-noise fast path on INTERIOR appends: the stream's frozen
    Fourier anchor (freqs = k/tspan, day0) is then the cold fit's own
    basis and parity is tight."""
    par, t = red
    idx = np.arange(300)
    inter = idx[INTERIOR[0]:INTERIOR[1]]
    keep = np.array(sorted(set(idx.tolist()) - set(inter.tolist())))
    base = take_rows(t, keep)
    t1, t2 = take_rows(t, inter[:20]), take_rows(t, inter[20:])
    s = engine.open_stream(par, base)
    try:
        assert s._state["sig_L"].shape[0] == 20
        r1 = s.append(t1).result(timeout=300)
        r2 = s.append(t2).result(timeout=300)
        assert (r1.refit, r2.refit) == ("incremental", "incremental")
        assert ref["__meta__"]["red_rungs"] == [r1.refit, r2.refit]
        _parity(engine, s, [base, t1, t2],
                tol_delta=1e-4, tol_unc=1e-4, tol_chi2=1e-6)
        _at_reference(ref, "red", s)
    finally:
        s.close()


def test_ecorr_serves_appends_on_warm_rung(engine, ref):
    """Quantized bases (ECORR epochs) have no incremental path: every
    append is a warm full refit — exact parity by construction."""
    par, t = _pulsar(ref, "ecorr")
    base, t1 = _rows(t, 0, 180), _rows(t, 180, 200)
    s = engine.open_stream(par, base)
    try:
        assert s._state is None  # stream_fast_path is None
        r1 = s.append(t1).result(timeout=300)
        assert r1.refit == "warm" == ref["__meta__"]["ecorr_rungs"][0]
        _parity(engine, s, [base, t1],
                tol_delta=1e-7, tol_unc=1e-9, tol_chi2=1e-12)
        _at_reference(ref, "ecorr", s)
    finally:
        s.close()


def test_ecorr_compositions_follow_the_epoch_count(engine, ref):
    """An ECORR quantization matrix has one column an epoch: the stream's
    open set and its merged set key two compositions (two sessions whose
    programs take differently shaped inputs), where a composition cached
    per par alone served the second set through the first set's program
    (on the card a shape mismatch)."""
    from pint_tpu_torch.serve.session import request_bundles

    par, t = _pulsar(ref, "ecorr")
    rec = engine.sessions.record_for(par)
    base, full = _rows(t, 0, 180), merge_tables(
        rec.model, [_rows(t, 0, 180), _rows(t, 180, 200)])
    ka = rec.composition_for(request_bundles(rec.model, base)[0])
    kb = rec.composition_for(request_bundles(rec.model, full)[0])
    ua = request_bundles(rec.model, base)[0].masks["ECORR1:U"].shape[1]
    ub = request_bundles(rec.model, full)[0].masks["ECORR1:U"].shape[1]
    assert ua != ub
    assert ka != kb
    assert rec.composition_for(request_bundles(rec.model, base)[0]) == ka


# -- no builds at steady state --------------------------------------------
def test_zero_builds_at_steady_state(engine, white):
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 200))
    try:
        # the first append builds the tail bucket's append program
        s.append(_rows(t, 200, 220)).result(timeout=300)
        traces0 = obs_metrics.counter("compile.traces").value
        for lo in (220, 240, 260, 280):
            r = s.append(_rows(t, lo, lo + 20)).result(timeout=300)
            assert r.refit == "incremental"
        assert obs_metrics.counter("compile.traces").value == traces0, \
            "steady-state appends must not build"
    finally:
        s.close()


def test_fit_x0_warm_start_zero_builds(engine, white):
    par, t = white
    toas = _rows(t, 0, 250)
    cold = engine.submit(FitRequest(par=par, toas=toas, maxiter=4)
                         ).result(timeout=300)
    traces0 = obs_metrics.counter("compile.traces").value
    warm = engine.submit(FitRequest(par=par, toas=toas, maxiter=4,
                                    x0=np.asarray(cold.deltas))
                         ).result(timeout=300)
    assert obs_metrics.counter("compile.traces").value == traces0
    assert warm.converged
    unc = np.asarray(cold.uncertainties)
    diff = np.abs(np.asarray(warm.deltas) - np.asarray(cold.deltas))
    assert np.all(diff <= 1e-6 * unc), diff / unc


# -- refresh cadence ------------------------------------------------------
def test_refresh_cadence(engine, white):
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 220), refresh=2)
    try:
        refreshes0 = obs_metrics.counter("serve.stream.refresh").value
        rs = [s.append(_rows(t, lo, lo + 20)).result(timeout=300)
              for lo in (220, 240, 260, 280)]
        assert [r.refit for r in rs] == [
            "incremental", "incremental", "warm", "incremental",
        ]
        # the warm rung re-anchored the solver state
        assert obs_metrics.counter(
            "serve.stream.refresh").value >= refreshes0 + 1
        assert s._state is not None
    finally:
        s.close()


def test_refresh_env_knob(monkeypatch, engine, white):
    """``PINT_TPU_STREAM_REFRESH`` is the refresh keyword's default."""
    monkeypatch.setenv("PINT_TPU_STREAM_REFRESH", "1")
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 260))
    try:
        rs = [s.append(_rows(t, lo, lo + 20)).result(timeout=300)
              for lo in (260, 280)]
        assert [r.refit for r in rs] == ["incremental", "warm"]
    finally:
        s.close()


# -- the fallback chain ---------------------------------------------------
def test_drift_guard_state_corruption_falls_back_warm(engine, white):
    """A corrupted solver state (non-SPD normal equations) NaN-poisons the
    incremental solve; the per-row drift refusal fails over to the warm
    rung on the SAME caller future, and the refit re-anchors."""
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 260))
    try:
        assert s._state is not None
        fb0 = obs_metrics.counter("serve.stream.drift_fallback").value
        s._state["G"] = -np.asarray(s._state["G"])  # non-SPD
        r = s.append(_rows(t, 260, 280)).result(timeout=300)
        assert r.refit == "warm"
        assert obs_metrics.counter(
            "serve.stream.drift_fallback").value == fb0 + 1
        # the refit rebuilt a CLEAN state: the next append is incremental
        r2 = s.append(_rows(t, 280, 300)).result(timeout=300)
        assert r2.refit == "incremental"
        _parity(engine, s, [_rows(t, 0, 260), _rows(t, 260, 280),
                            _rows(t, 280, 300)],
                tol_delta=1e-6, tol_unc=1e-9, tol_chi2=1e-9)
    finally:
        s.close()


def test_fourier_factor_drift_check_falls_back_warm(engine, red):
    """The maintained-factor drift check (``factor_solve_ir``'s residual
    against the TRUE Sigma): a corrupted factor fails it, poisons to NaN,
    and the append lands warm."""
    par, t = red
    s = engine.open_stream(par, _rows(t, 0, 260))
    try:
        assert s._state is not None
        assert s._state["sig_L"].shape[0] > 0
        fb0 = obs_metrics.counter("serve.stream.drift_fallback").value
        s._state["sig_L"] = np.asarray(s._state["sig_L"]) * 37.0
        r = s.append(_rows(t, 260, 280)).result(timeout=300)
        assert r.refit == "warm"
        assert obs_metrics.counter(
            "serve.stream.drift_fallback").value == fb0 + 1
    finally:
        s.close()


def test_injected_dispatch_fault_falls_back_warm(white):
    """``PINT_TPU_FAULTS`` at the append's site: the replica-level failure
    resolves the caller's future through the warm rung — typed, never a
    hang."""
    par, t = white
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=2.0,
                       inflight=2)
    try:
        s = eng.open_stream(par, _rows(t, 0, 260))
        try:
            with guard.configured(max_retries=0):
                with faults.inject("nan:inf@serve:append"):
                    r = s.append(_rows(t, 260, 280)).result(timeout=300)
            assert r.refit == "warm"
        finally:
            s.close()
    finally:
        eng.close(timeout=60)


def test_failed_append_batch_leaves_state_unchanged(white):
    """Every rung failing (the append batch poisoned, every refit
    poisoned): the caller's future raises typed, and the stream's solver
    state, solution and TOA count are bitwise as they were."""
    par, t = white
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=2.0,
                       inflight=2, quarantine_n=100)
    try:
        s = eng.open_stream(par, _rows(t, 0, 260))
        try:
            before = {k: np.array(v, copy=True)
                      for k, v in s._state.items()}
            x0, n0, chi0 = s.deltas, s.ntoa, s.chi2
            with guard.configured(max_retries=0):
                with faults.inject("nan:inf@serve:"):
                    with pytest.raises(PintTpuNumericsError):
                        s.append(_rows(t, 260, 280)).result(timeout=300)
            assert set(s._state) == set(before)
            for k, v in before.items():
                np.testing.assert_array_equal(s._state[k], v)
            np.testing.assert_array_equal(s.deltas, x0)
            assert (s.ntoa, s.chi2) == (n0, chi0)
            # and it carries on from there
            r = s.append(_rows(t, 260, 280)).result(timeout=300)
            assert r.refit == "incremental" and s.ntoa == 280
        finally:
            s.close()
    finally:
        eng.close(timeout=60)


def test_drift_rollback_fails_only_its_row(engine, white):
    """Two streams' appends stacked in one batch, one of them with a
    corrupted state: the in-program drift guard fails that row alone (its
    state rolled back to its input), and the other row serves."""
    par, t = white
    good = engine.open_stream(par, _rows(t, 0, 260))
    bad = engine.open_stream(par, _rows(t, 0, 260))
    try:
        state = dict(bad._state)
        state["G"] = -np.asarray(state["G"])
        reqs = [AppendRequest(par=par, toas=_rows(t, 260, 280),
                              state=st, ntoa_prev=260)
                for st in (good._state, state)]
        futs = engine.submit_many(reqs)
        ok = futs[0].result(timeout=300)
        with pytest.raises(PintTpuNumericsError):
            futs[1].result(timeout=300)
        assert ok.batch_size == 2 and ok.refit == "incremental"
        assert np.all(np.isfinite(ok.deltas))
    finally:
        good.close()
        bad.close()


# -- residual alerts ------------------------------------------------------
def test_glitch_tail_raises_alert(engine, white):
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 280))
    try:
        alerts0 = obs_metrics.counter("serve.stream.alerts").value
        tail = _rows(t, 280, 300)
        # a 200 us glitch against ~1 us white errors
        tail["tdb_sec_hi"] = tail["tdb_sec_hi"] + 2e-4
        r = s.append(tail).result(timeout=300)
        assert r.alerts, "glitched tail must raise a residual alert"
        assert "chi2-jump" in r.alerts[0]
        assert obs_metrics.counter(
            "serve.stream.alerts").value == alerts0 + 1
    finally:
        s.close()


# -- typed shedding -------------------------------------------------------
def test_stream_cap_sheds_typed(white, monkeypatch):
    par, t = white
    monkeypatch.setenv("PINT_TPU_SERVE_STREAMS", "1")
    eng = TimingEngine(device="cpu", max_batch=4, max_wait_ms=2.0,
                       inflight=2)
    try:
        s = eng.open_stream(par, _rows(t, 0, 200))
        with pytest.raises(RequestRejected, match="streams"):
            eng.open_stream(par, _rows(t, 0, 200))
        s.close()
        # closing released the slot
        s2 = eng.open_stream(par, _rows(t, 0, 200))
        s2.close()
    finally:
        eng.close(timeout=60)


def test_closed_stream_append_sheds_typed(engine, white):
    par, t = white
    s = engine.open_stream(par, _rows(t, 0, 200))
    s.close()
    with pytest.raises(RequestRejected, match="stream-closed"):
        s.append(_rows(t, 200, 220))


def test_stats_stream_block(engine):
    st = engine.stats()["stream"]
    for key in ("open", "appends", "incremental", "warm_refits",
                "cold_refits", "refreshes", "alerts"):
        assert key in st
    assert st["appends"] >= 1
    assert st["incremental"] >= 1
    assert st["warm_refits"] >= 1


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_card_append_replay_beside_another_replicas_capture():
    """Two replicas on one card: appends replay on one while the other
    captures a new fit program; every append serves incrementally and
    every fit is finite (the device lock takes a capture and the other
    replica's replays in turns)."""
    from pint_tpu_torch.simulation import make_test_pulsar

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    m, t = make_test_pulsar(PAR, ntoa=600, seed=42, iterations=1,
                            device="cpu")
    par = m.as_parfile()
    with TimingEngine(device="cuda", replicas=2, affinity=1, max_batch=4,
                      max_wait_ms=2.0, inflight=2) as eng:
        s = eng.open_stream(par, _rows(t, 0, 400))
        s.append(_rows(t, 400, 420)).result(timeout=300)
        errors, rungs = [], []

        def appends():
            try:
                for lo in range(420, 600, 20):
                    rungs.append(s.append(_rows(t, lo, lo + 20))
                                 .result(timeout=300).refit)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        th = threading.Thread(target=appends)
        th.start()
        try:
            fits = [f.result(timeout=300) for f in eng.submit_many(
                [FitRequest(par=par, toas=_rows(t, 0, n), maxiter=2)
                 for n in (90, 150, 300)])]
            res = eng.submit(ResidualsRequest(par=par, toas=t)).result(
                timeout=300)
        finally:
            th.join(timeout=600)
        s.close()
    assert not errors, errors
    assert rungs and set(rungs) == {"incremental"}
    assert all(np.isfinite(f.chi2) for f in fits)
    assert np.isfinite(res.chi2)
