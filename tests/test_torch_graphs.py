"""The step programs of the port's fit loops (``runtime/graphs.py``).

On the card each fit step, downhill iteration and batched PTA step is a
CUDA graph, captured once and replayed.  A graph cannot hold a read of a
device value on the host, so here, on the CPU, every function a fit
would capture runs under ``NoHostReads``, a torch function mode that
raises on each such read (``Tensor.item``, ``bool``, ``float``, ``int``,
``tolist``, ``cpu``, ``numpy``, a 0-d or boolean tensor index, the
data-dependent shapes of ``nonzero`` and its kin, a copy of host data to
the device) and on each ``torch.linalg`` call that checks its result on
the host unless the step routes it through ``graphs.host_call``.  The
functions are run through the real entry points (``GLSFitter``,
``WLSFitter``, the downhill fitters, ``PTABatch.fit``), by wrapping the
step program's call.  Then the program's CPU protocol, the cache's
invalidation by ``commit``, the device-side QR gate, and, on the card
(``gpu``), each graphed step bitwise equal to its eager step with its
kernel launches counted per replay.
"""

import math
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import BENCH_PAR  # noqa: E402

from pint_tpu_torch.fitting import (  # noqa: E402
    DownhillGLSFitter,
    DownhillWLSFitter,
    GLSFitter,
    WLSFitter,
)
from pint_tpu_torch.fitting import downhill as downhill_mod  # noqa: E402
from pint_tpu_torch.fitting.wls import (  # noqa: E402
    _QR_COND_MAX,
    _QR_DIAG_RTOL,
    _qr_gate,
    _wls_step,
)
from pint_tpu_torch.ops import fourier, fused_gram  # noqa: E402
from pint_tpu_torch.parallel.pta import PTABatch  # noqa: E402
from pint_tpu_torch.runtime import graphs  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
    pta_pars,
)

F64 = torch.float64

#: Tensor methods that read a device value on the host
HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__float__,
              torch.Tensor.__int__, torch.Tensor.__index__,
              torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy}
#: functions whose output shape depends on the data (a host read)
DATA_SHAPES = {torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
               torch.Tensor.masked_select, torch.unique, torch.Tensor.unique,
               torch.argwhere, torch.repeat_interleave}
#: copies of host data to a device (without one, a host scalar: a
#: constant of the graph)
HOST_COPIES = {torch.tensor, torch.as_tensor, torch.from_numpy}
#: library calls that check their result on the host (their ``_ex`` forms
#: with ``check_errors=False``, QR and the triangular solve do not)
CHECKED = {torch.linalg.eigh, torch.linalg.eigvalsh, torch.linalg.eig,
           torch.linalg.cholesky, torch.linalg.inv, torch.linalg.solve,
           torch.linalg.svd, torch.linalg.svdvals, torch.linalg.lstsq,
           torch.linalg.pinv, torch.linalg.matrix_rank, torch.linalg.det}


def _in_host_call():
    f = sys._getframe()
    while f is not None:
        if f.f_code is graphs._HostCall.forward.__code__:
            return True
        f = f.f_back
    return False


def _host_index(idx):
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor)
               and (i.dtype == torch.bool or (i.dim() == 0
                                              and not i.is_floating_point()))
               for i in items)


class NoHostReads(TorchFunctionMode):
    """Raise on every operation a CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls += 1
        name = getattr(func, "__name__", repr(func))
        if func in HOST_READS:
            raise AssertionError(f"host read {name} inside a step program")
        if func in DATA_SHAPES:
            raise AssertionError(f"data-dependent shape {name} inside a "
                                 "step program")
        if func in HOST_COPIES and kwargs.get("device") is not None and not (
                args and isinstance(args[0], torch.Tensor)):
            raise AssertionError(f"host data copied by {name} inside a step "
                                 "program")
        if func in CHECKED and not _in_host_call():
            raise AssertionError(f"{name} checks its result on the host: "
                                 "route it through graphs.host_call")
        if func is torch.Tensor.__getitem__ and _host_index(args[1]):
            raise AssertionError("a 0-d integer or boolean tensor index is "
                                 "read on the host")
        if func is torch.Tensor.to and any(
                str(a) == "cpu" for a in (*args[1:], *kwargs.values())):
            raise AssertionError("a copy to the host inside a step program")
        return func(*args, **kwargs)


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every step program's function runs as the card runs it: a first,
    eager warm-up call, which may build lazy tables, then every call
    under NoHostReads, as the capture and the replays run.  -> the
    programs called, one entry a call."""
    called = []
    real = graphs.StepProgram.__call__
    warm = set()

    def guarded(self, *args):
        called.append(self)
        if id(self) not in warm:
            warm.add(id(self))
            self.fn(*args)
        mode = NoHostReads()
        with mode:
            out = real(self, *args)
        assert mode.calls > 0
        return out

    monkeypatch.setattr(graphs.StepProgram, "__call__", guarded)
    return called


def _card_route(monkeypatch):
    """The card's routes on the CPU: the fused Gram's plain version and
    the refined solves."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")


def _bench(ntoa=256, device="cpu", par=BENCH_PAR):
    return make_test_pulsar(par, ntoa=ntoa, seed=0, orbit=True,
                            device=device)


def _msp(ntoa=2048, ndmx=12, device="cpu", par=None):
    return make_test_pulsar(par or msp_par(ndmx, seed=0), ntoa=ntoa,
                            start_mjd=53000.0, end_mjd=57500.0, seed=0,
                            iterations=1, orbit=True, orbit_in_phase=True,
                            freqs=MSP_FREQS, device=device)


def _white_par(ndmx=4):
    return "".join(ln + "\n" for ln in msp_par(ndmx, seed=0).splitlines()
                   if not ln.startswith("TNRED"))


def _pta(n=3, device="cpu"):
    cms = []
    for par, ntoa, seed in zip(pta_pars(n, ndmx=4, seed=5), (40, 64, 52),
                               (1, 2, 3)):
        m, t = make_test_pulsar(
            par, ntoa=ntoa, start_mjd=53000.0, end_mjd=57500.0, seed=seed,
            iterations=1, orbit=True, orbit_in_phase=True, freqs=MSP_FREQS,
            device=device)
        cms.append(m.compile(t, device=device))
    return PTABatch(cms)


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


# -- every captured function, under NoHostReads ---------------------------
@pytest.mark.parametrize("fused", ["mixed", False, True])
def test_bench_steps_hold_no_host_read(no_host_reads, monkeypatch, fused):
    """bench.py's pulsar: the mixed, f64 and fourier steps (GLSFitter's
    fused='mixed', False, True) on the card's routes."""
    _card_route(monkeypatch)
    model, toas = _bench()
    f = GLSFitter(toas, model, fused=fused, device="cpu")
    chi2 = _quiet(f.fit_toas, maxiter=2)
    assert math.isfinite(chi2) and f.steps_taken == len(no_host_reads) >= 1
    assert f.mode == {"mixed": "mixed", False: "f64", True: "fourier"}[fused]


def test_msp_mixed_step_holds_no_host_read(no_host_reads, monkeypatch):
    """The 2048-TOA copy of the binary MSP (12 DMX ranges, ELL1, FD, a
    JUMP, red noise): one mixed step."""
    _card_route(monkeypatch)
    model, toas = _msp()
    f = GLSFitter(toas, model, fused="mixed", device="cpu")
    assert math.isfinite(_quiet(f.fit_toas, maxiter=1))
    assert len(no_host_reads) == 1


def test_downhill_gls_iteration_holds_no_host_read(no_host_reads,
                                                   monkeypatch):
    """One downhill GLS iteration (the mixed proposal, the vmapped lambda
    ladder, the noise floor, accept/stop) and the final proposal."""
    _card_route(monkeypatch)
    model, toas = _bench()
    f = DownhillGLSFitter(toas, model, device="cpu")
    assert math.isfinite(_quiet(f.fit_toas, maxiter=1))
    assert f.guard_report.rung == "native" and len(no_host_reads) == 2


def test_downhill_wls_qr_iteration_holds_no_host_read(no_host_reads,
                                                      monkeypatch):
    """One downhill WLS iteration with the card's method, 'qr' (its gate
    a device predicate, its gram answer's eigh a host call)."""
    monkeypatch.setattr(downhill_mod, "default_wls_method", lambda d: "qr")
    model, toas = _msp(ntoa=512, par=_white_par())
    f = DownhillWLSFitter(toas, model, device="cpu")
    assert math.isfinite(_quiet(f.fit_toas, maxiter=1))
    assert f.guard_report.rung == "native" and len(no_host_reads) == 2


def test_wls_qr_step_holds_no_host_read(no_host_reads, monkeypatch):
    """WLSFitter's step with 'qr'; the gate is read after the fit."""
    from pint_tpu_torch.fitting import wls

    monkeypatch.setattr(wls, "default_wls_method", lambda d: "qr")
    model, toas = _msp(ntoa=512, par=_white_par())
    f = WLSFitter(toas, model, device="cpu")
    assert math.isfinite(_quiet(f.fit_toas, maxiter=2))
    assert f.steps_taken == len(no_host_reads) >= 1
    assert f.qr_gate["rank_ok"] and 0.0 < f.qr_gate["diag_ratio"] <= 1.0


@pytest.mark.parametrize("mode", ["mixed", "f64"])
def test_pta_batched_step_holds_no_host_read(no_host_reads, monkeypatch,
                                             mode):
    """The 3-pulsar batched step (vmap over the pulsar axis, the f64
    step's eigh split on the physical batch): maxiter + 1 calls."""
    _card_route(monkeypatch)
    batch = _pta()
    xs, chi2 = _quiet(batch.fit, maxiter=2, mode=mode)
    assert batch.steps_taken == 3 == len(no_host_reads)
    assert bool(torch.all(torch.isfinite(chi2)))


#: every golden composition the port simulates (golden22's topocentric
#: TZR row through the port's own ingest)
GOLDENS = [f"golden{i}" for i in range(1, 24)]
#: the wideband compositions, simulated with a DM measurement a TOA
WIDEBAND = ("golden4", "golden17", "msp_wideband")


@pytest.mark.parametrize("par", GOLDENS + ["msp_full", "msp_wideband"])
def test_compositions_hold_no_host_read(no_host_reads, monkeypatch, par):
    """Every component a fit on the card may capture: the step of each
    golden composition (the ten binary models, DMX, JUMP, FD, FDJUMP,
    solar wind and SWX, glitch, WAVE, WaveX and kin, IFUNC, piecewise
    spindown, ChromaticCM, the troposphere, DM and ECORR noise, wideband
    DMJUMP/DMEFAC/DMEQUAD) and of the full-width and wideband MSPs, in
    the card's mode for it (mixed with correlated noise, else f64), at
    128 TOAs (golden4's and golden17's with wideband TOAs)."""
    from pint_tpu_torch.fitting import WidebandTOAFitter
    from pint_tpu_torch.simulation import msp_full_par, msp_wideband_par

    _card_route(monkeypatch)
    text = {"msp_full": lambda: msp_full_par(4, seed=0),
            "msp_wideband": lambda: msp_wideband_par(4, seed=0)}.get(
        par, lambda: (Path(__file__).parent / "datafile"
                      / f"{par}.par").read_text())()
    extra = {"dm_error": 2e-4} if par in WIDEBAND else {}
    model, toas = _quiet(make_test_pulsar, text, ntoa=128, start_mjd=53000.0,
                         end_mjd=57500.0, seed=0, iterations=1, orbit=True,
                         orbit_in_phase=True, freqs=MSP_FREQS, device="cpu",
                         **extra)
    cls = WidebandTOAFitter if par in WIDEBAND else GLSFitter
    f = cls(toas, model, device="cpu")
    mode = "mixed" if f.cm.has_correlated_errors else "f64"
    prog = graphs.StepProgram(lambda x: f._gn_step(x, mode), "cpu")
    out = _quiet(prog, f.cm.x0())
    assert len(no_host_reads) == 1
    assert bool(torch.all(torch.isfinite(out[0])))


def _mixed_full_cov(monkeypatch):
    """The card's full_cov method on the CPU: the mixed dense step, its
    refined solves armed."""
    from pint_tpu_torch.fitting import gls

    _card_route(monkeypatch)
    monkeypatch.setattr(gls, "full_cov_method",
                        lambda device, method=None: method or "mixed")


@pytest.mark.parametrize("fused", ["auto", False])
def test_full_cov_steps_hold_no_host_read(no_host_reads, monkeypatch,
                                          fused):
    """GLSFitter(full_cov=True): the mixed dense step (the card's, the
    equilibrated f32 covariance refined with the true operator) and the
    f64 dense step (fused=False: the n x n f64 factor, then the eigh
    host call)."""
    _mixed_full_cov(monkeypatch)
    model, toas = _bench()
    f = GLSFitter(toas, model, True, fused, device="cpu")
    assert f._full_cov_method() == ("f64" if fused is False else "mixed")
    chi2 = _quiet(f.fit_toas, maxiter=2)
    assert math.isfinite(chi2) and f.steps_taken == len(no_host_reads) >= 1
    assert f.mode == "full_cov" and f.guard_report.rung == "cpu-full_cov"


@pytest.mark.parametrize("wideband", [False, True])
def test_full_cov_downhill_iteration_holds_no_host_read(no_host_reads,
                                                        monkeypatch,
                                                        wideband):
    """One downhill iteration with the mixed dense proposal, and the final
    proposal: DownhillGLSFitter on bench.py's pulsar, and
    WidebandDownhillFitter on golden17's composition with DM measurements
    (the dense step over the 2n stacked rows)."""
    from pint_tpu_torch.fitting import WidebandDownhillFitter

    _mixed_full_cov(monkeypatch)
    if wideband:
        text = (Path(__file__).parent / "datafile" / "golden17.par"
                ).read_text()
        model, toas = _quiet(make_test_pulsar, text, ntoa=128,
                             start_mjd=53000.0, end_mjd=57500.0, seed=0,
                             iterations=1, orbit=True, orbit_in_phase=True,
                             freqs=MSP_FREQS, dm_error=2e-4, device="cpu")
        f = WidebandDownhillFitter(toas, model, True, device="cpu")
    else:
        model, toas = _bench()
        f = DownhillGLSFitter(toas, model, True, device="cpu")
    assert math.isfinite(_quiet(f.fit_toas, maxiter=1))
    assert f.guard_report.rung == "native" and len(no_host_reads) == 2


@pytest.mark.parametrize("factor", ["f32", "f64"])
def test_stream_append_and_solve_hold_no_host_read(no_host_reads,
                                                   monkeypatch, factor):
    """The streaming solver's append (the additive blocks and the rank-j
    update of the maintained factor, column by column) and solve (the
    refined solves, the linearized advance, the drift rollback), each as
    a step program, with the card's f32 factor and with the CPU's f64."""
    from pint_tpu_torch.fitting import gls
    from pint_tpu_torch.ops import solve_policy

    if factor == "f32":
        monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    rng = np.random.default_rng(7)
    n, p, k = 96, 5, 8
    M = torch.as_tensor(rng.standard_normal((n, p)))
    r = torch.as_tensor(rng.standard_normal(n) * 1e-3)
    Ninv = torch.as_tensor(rng.uniform(0.5, 2.0, n))
    T = torch.as_tensor(rng.standard_normal((n, k)))
    phi = torch.as_tensor(rng.uniform(0.1, 10.0, k))
    st = gls.stream_state_init(r[:64], M[:64], Ninv[:64], T[:64], phi,
                               torch.zeros(p - 1, dtype=F64))
    leaves, rebuild = graphs.flatten(st)
    append = graphs.StepProgram(
        lambda *a: gls.stream_state_append(rebuild(list(a[:-4])), *a[-4:]),
        "cpu")
    solve = graphs.StepProgram(
        lambda *a: gls.stream_state_solve(
            rebuild(list(a)), 1, check_rtol=solve_policy.stream_drift_rtol()),
        "cpu")
    st = append(*leaves, r[64:], M[64:], Ninv[64:], T[64:])
    out, dx, _, chi2 = solve(*graphs.flatten(st)[0])
    assert len(no_host_reads) == 2
    assert st["sig_L"].dtype == (torch.float32 if factor == "f32" else F64)
    assert bool(torch.all(torch.isfinite(dx))) and math.isfinite(float(chi2))


# -- the inference slice's programs -----------------------------------------
def test_mcmc_steps_hold_no_host_read(no_host_reads):
    """MCMCFitter: every stretch step (two half-ensemble proposals, the
    vmapped log-posterior with its red noise marginalized through the
    NaN-poisoning Cholesky, the accept/where) is one program call."""
    from pint_tpu_torch.sampler import MCMCFitter

    model, toas = _bench(128)
    f = MCMCFitter(toas, model, device="cpu")
    _quiet(f.fit_toas, nsteps=3, nwalkers=12, seed=1)
    assert len(no_host_reads) == 3 and f.bt.cm.programs.replays == 0


def test_lnposterior_batch_and_nested_hold_no_host_read(no_host_reads):
    """BayesianTiming's batched log-posterior program, and nested
    sampling's likelihood programs (the live set's, the proposals')."""
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.models.priors import UniformBoundedRV

    model, toas = _bench(128)
    bt = BayesianTiming(model, toas, device="cpu")
    X = torch.zeros((8, bt.nparams), dtype=F64)
    assert bool(torch.isfinite(bt.lnposterior_batch(8)(X)).all())
    sig = [1e-9, 1e-8, 1e-4, 1e-11, 1e-18]
    bn = BayesianTiming(
        model, toas, device="cpu",
        priors={n: UniformBoundedRV(-s, s)
                for n, s in zip(bt.param_names, sig)})
    res = bn.sample_nested(nlive=20, dlogz=5.0, batch=16, seed=2)
    assert np.isfinite(res["logz"]) and len(no_host_reads) >= 3


def test_grid_chunk_holds_no_host_read(no_host_reads, monkeypatch):
    """A grid chunk on the card's route: the vmapped refits' WLS solve by
    QR with its device-side gate (the gram answer's eigh a host call)."""
    from pint_tpu_torch.fitting import wls
    from pint_tpu_torch.gridutils import grid_chisq

    monkeypatch.setattr(wls, "default_wls_method", lambda d: "qr")
    model, toas = _msp(ntoa=256, ndmx=4)
    chi2 = grid_chisq(toas, model, {"M2": [0.19, 0.21],
                                    "SINI": [0.997, 0.998, 0.999]},
                      device="cpu", chunk=4)
    assert chi2.shape == (2, 3) and np.all(np.isfinite(chi2))
    assert len(no_host_reads) == 2


def test_no_host_reads_catches_reads():
    """The mode itself: each kind of read raises; host_call passes eigh."""
    t = torch.ones(3, dtype=F64)
    A = torch.eye(3, dtype=F64)
    for bad in (lambda: float(t.sum()), lambda: bool(t.sum() > 0),
                lambda: t.tolist(), lambda: t[torch.tensor(1)],
                lambda: torch.nonzero(t), lambda: torch.linalg.eigh(A),
                lambda: torch.tensor([1.0], device="cpu")):
        with pytest.raises(AssertionError), NoHostReads():
            bad()
    with NoHostReads():
        w, _ = graphs.host_call(torch.linalg.eigh, A)
        t.index_select(0, torch.zeros(1, dtype=torch.long))
    assert torch.equal(w, torch.ones(3, dtype=F64))


# -- the program's CPU protocol and the cache ------------------------------
def test_cpu_program_is_the_function():
    """On the CPU a program calls its function: the same results, and an
    output kept across a later call is not overwritten."""
    def fn(x, y):
        return x * 2.0 + y, (torch.sum(x), None)

    prog = graphs.StepProgram(fn, "cpu")
    x1, x2 = torch.arange(4, dtype=F64), torch.ones(4, dtype=F64)
    y = torch.full((4,), 0.5, dtype=F64)
    a = prog(x1, y)
    keep = a[0].clone()
    b = prog(x2, y)
    assert torch.equal(a[0], keep) and not torch.equal(a[0], b[0])
    want = fn(x1, y)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1][0], want[1][0])
    assert a[1][1] is None and not prog.captured and prog.replays == 0


def test_commit_drops_cached_programs():
    """CompiledModel.program caches by key until commit(); a fit commits,
    so it leaves no program behind."""
    model, toas = _bench(64)
    cm = model.compile(toas, device="cpu")
    p1 = cm.program(cm.chi2, ("chi2",))
    assert cm.program(cm.time_residuals, ("chi2",)) is p1 and len(
        cm.programs) == 1
    x = cm.x0()
    assert torch.equal(p1(x), cm.chi2(x))
    cm.commit(x.numpy())
    assert len(cm.programs) == 0
    assert cm.program(cm.chi2, ("chi2",)) is not p1
    f = GLSFitter(toas, model, device="cpu")
    _quiet(f.fit_toas, maxiter=2)
    assert len(f.cm.programs) == 0


def test_host_call_splits_under_vmap():
    """host_call inside torch.func.vmap calls its op once on the whole
    batch and gives each member its own result."""
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((3, 4, 4)))
    A = B @ B.transpose(1, 2) + 4 * torch.eye(4, dtype=F64)
    calls = []

    def op(a):
        calls.append(tuple(a.shape))
        return torch.linalg.eigh(a)

    w, V = torch.func.vmap(lambda a: graphs.host_call(op, a))(A)
    assert calls == [(3, 4, 4)]
    for i in range(3):
        wi, Vi = torch.linalg.eigh(A[i])
        assert torch.allclose(w[i], wi, rtol=1e-13, atol=0)
        assert torch.allclose(torch.abs(V[i]), torch.abs(Vi), atol=1e-12)


# -- the device-side QR gate ------------------------------------------------
def _host_gate(R):
    """The gate as it was read on the host before it became a device
    predicate."""
    diag = torch.abs(torch.diagonal(R))
    z = torch.linalg.solve_triangular(
        R, torch.ones((R.shape[1], 1), dtype=R.dtype), upper=True)
    cond = torch.max(torch.abs(z)) * diag.max()
    return bool((diag.min() > _QR_DIAG_RTOL * diag.max())
                & torch.isfinite(cond) & (cond < _QR_COND_MAX))


def _normalized(r, M, w):
    sw = torch.sqrt(w)
    nrm = torch.linalg.vector_norm(M * sw[:, None], dim=0)
    return (M / nrm[None, :]) * sw[:, None], -r * sw


@pytest.mark.parametrize("case", ["well", "deficient"])
def test_device_qr_gate_takes_the_host_gates_route(case):
    """On a well-conditioned design the gate passes and 'qr' returns the
    QR answer; on a rank-deficient one (a column repeated) it fails and
    'qr' returns the gram answer, bit for bit; the old host gate decides
    the same."""
    rng = np.random.default_rng(4)
    M = torch.as_tensor(rng.standard_normal((200, 6)))
    if case == "deficient":
        M[:, 5] = M[:, 2]
    r = torch.as_tensor(rng.standard_normal(200))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 200))
    A, _ = _normalized(r, M, w)
    R = torch.linalg.qr(A)[1]
    ok, ratio, cond = _qr_gate(R)
    assert ok.dim() == 0 and bool(ok) == _host_gate(R) == (case == "well")
    assert float(ratio) > 0.0 or case == "deficient"
    got = _wls_step(r, M, w, method="qr", with_gate=True)
    gram = _wls_step(r, M, w, method="gram")
    if case == "well":
        Q, R = torch.linalg.qr(A)
        _, b = _normalized(r, M, w)
        want = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None],
                                             upper=True)[:, 0]
        scale = float(torch.max(torch.abs(want)))
        nrm = torch.linalg.vector_norm(M * torch.sqrt(w)[:, None], dim=0)
        assert torch.allclose(got[0] * nrm, want, rtol=0, atol=1e-12 * scale)
        assert int(got[2]) == 0
    else:
        assert all(torch.equal(a, b) for a, b in zip(got[:3], gram))
        assert int(got[2]) >= 1
    assert bool(got[3][0]) == (case == "well")


# -- on the card -------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _launch_counts():
    return (fused_gram.fused_gram_joint_cuda.launches,
            fourier.fourier_gram_cuda.launches)


def _graphed_equals_eager(fn, args, per_replay):
    """Program of ``fn`` against ``fn`` itself from the same inputs:
    bitwise, twice; each replay adds ``per_replay`` to the launch
    counts."""
    eager = graphs.flatten(fn(*args))[0]
    prog = graphs.StepProgram(fn, args[0].device)
    first = graphs.flatten(prog(*args))[0]
    before = _launch_counts()
    again = graphs.flatten(prog(*args))[0]
    torch.cuda.synchronize()
    after = _launch_counts()
    assert prog.captured and prog.replays == 2
    assert tuple(a - b for a, b in zip(after, before)) == per_replay
    for e, g, g2 in zip(eager, first, again):
        assert torch.equal(e, g) and torch.equal(g, g2)
    return prog


@pytest.mark.gpu
@pytest.mark.parametrize("mode,per_replay", [("mixed", (1, 0)),
                                             ("f64", (0, 0)),
                                             ("fourier", (0, 1))])
def test_graphed_step_equals_eager_on_card(mode, per_replay):
    """bench.py's pulsar at 4096 TOAs: each GLS step mode graphed, bitwise
    equal to the eager step; the f64 step's eigh splits it in two."""
    dev = _card()
    model, toas = _bench(4096, device=dev)
    f = GLSFitter(toas, model, device=dev)
    x = f.cm.x0()
    prog = _graphed_equals_eager(lambda x: f._gn_step(x, mode), (x,),
                                 per_replay)
    assert len(prog.segments) == (2 if mode == "f64" else 1)


@pytest.mark.gpu
def test_graphed_msp_and_downhill_equal_eager_on_card():
    """The 2048-TOA MSP copy's mixed step (the wide path), and one
    downhill GLS and one downhill WLS (QR) iteration, graphed, bitwise
    equal to eager."""
    dev = _card()
    model, toas = _msp(device=dev)
    f = GLSFitter(toas, model, device=dev)
    _graphed_equals_eager(lambda x: f._gn_step(x, "mixed"), (f.cm.x0(),),
                          (1, 0))
    d = DownhillGLSFitter(toas, model, device=dev)
    it, _, chi2_fn = d._make_iteration(False, 1e-2, 1e-2, 1e-3)
    x = d.cm.x0()
    false = torch.zeros((), dtype=torch.bool, device=dev)
    _graphed_equals_eager(it, (x, chi2_fn(x), false, false), (1, 0))
    wm, wt = _msp(ntoa=512, par=_white_par(), device=dev)
    w = DownhillWLSFitter(wt, wm, device=dev)
    it, _, chi2_fn = w._make_iteration(False, 1e-2, 1e-2, 1e-3)
    x = w.cm.x0()
    _graphed_equals_eager(it, (x, chi2_fn(x), false, false), (0, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,per_replay", [("mixed", (1, 0)),
                                             ("f64", (0, 0))])
def test_graphed_pta_step_equals_eager_on_card(mode, per_replay):
    """The 3-pulsar batched step graphed, bitwise equal to eager; the
    mixed one launches the batched Gram once a replay; the fit runs its
    maxiter + 1 steps as replays of one program."""
    dev = _card()
    batch = _pta(device=dev)
    _graphed_equals_eager(batch._step_fn(mode), (batch.x0(),), per_replay)
    replays = batch.programs.replays
    _quiet(batch.fit, maxiter=2, mode=mode)
    assert batch.programs.replays - replays == 3 == batch.steps_taken


@pytest.mark.gpu
def test_fits_on_card_run_as_replays():
    """GLSFitter and the downhill fitter on the card: every step a replay,
    one capture a program, and nothing cached after the fit."""
    dev = _card()
    model, toas = _bench(4096, device=dev)
    f = GLSFitter(toas, model, device=dev)
    _quiet(f.fit_toas, maxiter=3)
    assert f.cm.programs.replays == f.steps_taken
    assert f.cm.programs.captures == 1 and len(f.cm.programs) == 0
    d = DownhillGLSFitter(toas, model, device=dev)
    _quiet(d.fit_toas)
    assert d.cm.programs.replays == d.niter + 1
    assert d.cm.programs.captures == 2


@pytest.mark.gpu
def test_failed_capture_raises_on_card():
    """A host read inside a step fails its capture: the call raises, the
    program stays uncaptured and never runs the function eagerly in its
    place, and the launch counts the capture recorded are taken back."""
    dev = _card()
    x = torch.ones(8, dtype=F64, device=dev)
    T, A, w = (torch.ones((256, 4), dtype=F64, device=dev),
               torch.ones((256, 3), dtype=F64, device=dev),
               torch.ones(256, dtype=F64, device=dev))
    ran = []

    def step(x):
        ran.append(1)
        g = fused_gram.fused_gram_joint(T, A, w)[0]
        return x * float(g.sum())  # a host read: not capturable

    prog = graphs.StepProgram(step, dev)
    before = _launch_counts()
    with pytest.raises(RuntimeError):
        prog(x)
    torch.cuda.synchronize()
    # the warm-up ran eagerly and launched once; the capture's launch was
    # taken back, and nothing ran after the failed capture
    assert _launch_counts()[0] - before[0] == 1 and len(ran) == 2
    assert not prog.captured and prog.replays == 0
