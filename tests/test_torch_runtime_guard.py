"""The port's device-execution guard (``runtime/guard.py``, ``faults.py``,
``fallback.py``) against the reference's.

Port twins of ``tests/test_runtime_guard.py``: the fault grammar, error
classes, retries, the watchdog, the finite validator and its diagnosis,
the ladder, and fits under injected faults on the CPU — every recovered
fit equal to the clean fit, every unrecoverable one raising.  The
reference's sharded case waits for the multi-GPU mesh (ROADMAP A8); its
donation cases map to the retry copies of a program's own inputs
(``snapshot_inputs``) and to ``fence_owned``.  The port's ladder has no
host rung, so where the reference's fit falls to ``cpu`` the port's
raises ``LadderExhausted`` (ROADMAP C).  Port-only cases: attempts
inline on the calling thread, the abandoned attempt that launches
nothing, a wedged program rebuilt, the deadline on queued device work
kept at the host read, foreign errors (a kernel that did not build or
launch) propagating unretried and never served by another rung, and the
bypass inside ``torch.func``.  One reference subprocess gives the
reference's ``FaultPlan.parse`` and ``classify_error`` over one table of
specs and foreign errors, and the rung that served (with its history) on
the same 300-TOA pulsar under ``nan:inf`` on the native rung.  Injected
hangs sleep under 1 s.
"""

import json
import sys
import textwrap
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.exceptions import (  # noqa: E402
    GuardTimeout,
    GuardTripWarning,
    LadderExhausted,
    PintTpuError,
    PintTpuNumericsError,
    RetriesExhausted,
    TransientDispatchError,
    TransportRejection,
)
from pint_tpu_torch.fitting.downhill import DownhillGLSFitter  # noqa: E402
from pint_tpu_torch.fitting.gls import GLSFitter  # noqa: E402
from pint_tpu_torch.fitting.wls import WLSFitter  # noqa: E402
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from pint_tpu_torch.runtime import faults, guard  # noqa: E402
from pint_tpu_torch.runtime.fallback import fit_rungs, run_ladder  # noqa: E402
from pint_tpu_torch.runtime.graphs import ProgramCache  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

PAR_WHITE = "PSR G1\nF0 245.42 1\nF1 -5e-16 1\nPEPOCH 55000\nDM 3.14 1\n"
PAR_RED = PAR_WHITE + (
    "EFAC -f L-wide 1.3\nTNREDAMP -13.1\nTNREDGAM 3.3\nTNREDC 6\n"
)

# no real watchdog unless a test arms one; millisecond backoff
FAST = dict(backoff_base=0.001, backoff_max=0.002, jitter=0.0)

#: one table of specs for FaultPlan.parse, both packages
SPECS = [
    "hang:2@cm.jit, 413, transient:inf, nan:3@rung:cpu",
    "nan", "transient:1@cm.program", " 413:0 ", "hang:inf@x@y",
    "nan:inf@rung:cuda-mixed,transient:2", "",
    "segfault:1", "bogus@site", "hang:abc",
]

#: one table of foreign errors for classify_error, both packages
ERRORS = [
    ("RuntimeError", "Connection reset by peer"),
    ("RuntimeError", "HTTP 413: request entity too large"),
    ("ValueError", "bad shape"),
    ("RuntimeError", "Service Unavailable"),
    ("RuntimeError", "deadline exceeded while waiting"),
    ("RuntimeError", "message length 300000000 exceeds maximum"),
    ("OSError", "502 Bad Gateway"),
    ("RuntimeError", "CUDA error: an illegal memory access was encountered"),
    ("RuntimeError", "CUDA out of memory. Tried to allocate 2.00 GiB"),
    ("ConnectionError", "peer went away"),
    ("TimeoutError", ""),
    ("KeyError", "transient"),
]

_REF_SCRIPT = """
import warnings
from pint_tpu.exceptions import GuardTripWarning, PintTpuError
from pint_tpu.runtime import faults, guard
from pint_tpu.fitting.gls import GLSFitter
from pint_tpu.simulation import make_test_pulsar

parsed = []
for spec in SPECS:
    try:
        plan = faults.FaultPlan.parse(spec)
        parsed.append(["ok", [[e.kind, repr(e.remaining), e.site]
                              for e in plan.entries]])
    except Exception as e:
        parsed.append([type(e).__name__, str(e)])
OUT["parsed"] = np.array(json.dumps(parsed))
import builtins
OUT["classes"] = np.array(json.dumps(
    [guard.classify_error(getattr(builtins, t)(m)) for t, m in ERRORS]))

model, toas = make_test_pulsar(PAR_RED, ntoa=300, start_mjd=54000.0,
                               end_mjd=56000.0, seed=0, iterations=1)
f = GLSFitter(toas, model, fused="mixed")
export_state(f.cm, "p300")
with warnings.catch_warnings():
    warnings.simplefilter("ignore", GuardTripWarning)
    with faults.inject("nan:inf@rung:cpu-mixed"):
        chi2 = f.fit_toas()
OUT["report"] = np.array(json.dumps(f.guard_report.to_dict()))
OUT["chi2"] = np.array(chi2)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_guard")
    script = (f"SPECS = {SPECS!r}\nERRORS = {ERRORS!r}\n"
              f"PAR_RED = {PAR_RED!r}\n" + textwrap.dedent(_REF_SCRIPT))
    return run_reference(script, work / "ref.npz")


@pytest.fixture(autouse=True)
def _reset_stats():
    guard.STATS.reset()
    yield
    assert not faults.active(), "a test leaked an armed fault plan"


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


# -- fault-plan grammar ---------------------------------------------------
def test_fault_spec_grammar():
    plan = faults.FaultPlan.parse(
        "hang:2@cm.jit, 413, transient:inf, nan:3@rung:cpu"
    )
    assert [(e.kind, e.remaining, e.site) for e in plan.entries] == [
        ("hang", 2.0, "cm.jit"),
        ("413", 1.0, None),
        ("transient", float("inf"), None),
        ("nan", 3.0, "rung:cpu"),
    ]
    assert plan.take("413", "anywhere")
    assert not plan.take("413", "anywhere")
    assert plan.take("hang", "cm.jit:loop")
    assert not plan.take("hang", "elsewhere")
    assert plan.fired == [("413", "anywhere"), ("hang", "cm.jit:loop")]


def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(PintTpuError, match="unknown fault kind"):
        faults.FaultPlan.parse("segfault:1")


def test_inject_scope_discards_leftovers():
    with faults.inject("413:5"):
        assert faults.active()
    assert not faults.active()


def test_env_var_activation(monkeypatch):
    calls = []
    monkeypatch.setenv("PINT_TPU_FAULTS", "transient:1")
    with guard.configured(**FAST):
        out = guard.guarded_call(
            lambda: calls.append(1) or "ok", site="envtest"
        )
    assert out == "ok" and len(calls) == 1
    assert guard.STATS.retries == 1
    monkeypatch.setenv("PINT_TPU_FAULTS", "")


def test_fault_parse_and_classes_match_the_reference(ref):
    """FaultPlan.parse and classify_error over one table of specs and
    foreign error texts: the reference's output, string for string."""
    parsed = []
    for spec in SPECS:
        try:
            plan = faults.FaultPlan.parse(spec)
            parsed.append(["ok", [[e.kind, repr(e.remaining), e.site]
                                  for e in plan.entries]])
        except Exception as e:
            parsed.append([type(e).__name__, str(e)])
    assert parsed == json.loads(str(ref["parsed"]))
    import builtins

    classes = [guard.classify_error(getattr(builtins, t)(m))
               for t, m in ERRORS]
    assert classes == json.loads(str(ref["classes"]))


# -- error classification -------------------------------------------------
def test_classify_foreign_errors():
    assert guard.classify_error(
        RuntimeError("Connection reset by peer")) == "transient"
    assert guard.classify_error(
        RuntimeError("HTTP 413: request entity too large")) == "rejection"
    assert guard.classify_error(ValueError("bad shape")) == "fatal"
    assert guard.classify_error(TransientDispatchError("x")) == "transient"
    assert guard.classify_error(TransportRejection("x")) == "rejection"
    assert guard.classify_error(PintTpuNumericsError("nan")) == "fatal"


# -- guarded_call: retries ------------------------------------------------
def test_transient_faults_are_retried():
    with guard.configured(max_retries=2, **FAST):
        with faults.inject("transient:2"):
            assert guard.guarded_call(lambda: 42, site="t") == 42
    assert guard.STATS.retries == 2


def test_retries_exhausted_raises_structured():
    with guard.configured(max_retries=1, **FAST):
        with faults.inject("transient:inf"):
            with pytest.raises(RetriesExhausted) as ei:
                guard.guarded_call(lambda: 42, site="deadline")
    assert ei.value.attempts == 2
    assert isinstance(ei.value.last, TransientDispatchError)


def test_rejection_never_retried():
    with guard.configured(max_retries=5, **FAST):
        with faults.inject("413:1"):
            with pytest.raises(TransportRejection):
                guard.guarded_call(lambda: 42, site="big")
    assert guard.STATS.retries == 0
    assert guard.STATS.transport_rejections == 1


# -- guarded_call: watchdog ----------------------------------------------
def test_watchdog_trips_then_retry_recovers():
    with guard.configured(dispatch_timeout=0.25, max_retries=1, **FAST):
        with faults.inject("hang:1", hang_seconds=0.6):
            assert guard.guarded_call(lambda: "alive", site="wedge") \
                == "alive"
    assert guard.STATS.timeouts == 1
    assert guard.STATS.retries == 1
    assert guard.STATS.last_watchdog_margin_s is not None
    assert 0.0 < guard.STATS.last_watchdog_margin_s <= 0.25


def test_watchdog_exhausted_raises():
    with guard.configured(dispatch_timeout=0.2, max_retries=1, **FAST):
        with faults.inject("hang:inf", hang_seconds=0.6):
            with pytest.raises(GuardTimeout) as ei:
                guard.guarded_call(lambda: 1, site="wedge2")
    assert ei.value.timeout == 0.2
    assert "wedge2" in str(ei.value)
    assert guard.STATS.timeouts == 2


def test_no_watchdog_thread_on_cpu_defaults(monkeypatch):
    """The CPU config runs attempts inline: the guard is essentially
    free where nothing wedges."""
    monkeypatch.delenv("PINT_TPU_GUARD_DISPATCH_TIMEOUT", raising=False)
    cfg = guard.GuardConfig.from_env("cpu")
    assert cfg.compile_timeout is None and cfg.dispatch_timeout is None
    main = threading.current_thread()
    seen = []
    guard.guarded_call(
        lambda: seen.append(threading.current_thread()), site="inline",
        config=cfg,
    )
    assert seen == [main]
    # the card's defaults are the reference's accelerator watchdogs
    card = guard.GuardConfig.from_env("cuda")
    assert (card.compile_timeout, card.dispatch_timeout) == (2400.0, 900.0)


def test_armed_attempts_run_inline_on_the_calling_thread():
    """An armed watchdog starts no thread: every attempt, the retry of a
    timed-out one included, runs on the caller's thread."""
    seen = []
    before = threading.active_count()
    with guard.configured(dispatch_timeout=5.0, max_retries=1, **FAST):
        for _ in range(3):
            guard.guarded_call(
                lambda: seen.append(threading.current_thread()), site="w")
    with guard.configured(dispatch_timeout=0.2, max_retries=1, **FAST):
        with faults.inject("hang:1", hang_seconds=0.5):
            guard.guarded_call(
                lambda: seen.append(threading.current_thread()), site="w")
    assert seen == [threading.current_thread()] * 4
    assert threading.active_count() == before
    assert guard.STATS.timeouts == 1 and guard.STATS.retries == 1


def test_shorter_hang_only_delays_the_call():
    """A hang that ends before the deadline delays the call, which then
    runs: nothing times out."""
    with guard.configured(dispatch_timeout=0.5, max_retries=0, **FAST):
        with faults.inject("hang:1", hang_seconds=0.1):
            t0 = time.monotonic()
            assert guard.guarded_call(lambda: 3, site="short") == 3
    assert time.monotonic() - t0 >= 0.1
    assert guard.STATS.timeouts == 0


class _Work:
    """Queued device work as the guard sees it: an event that completes
    when ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_device_deadline_raises_at_the_host_read():
    """Work queued past its deadline (a wedged kernel) ends the host
    read's wait in GuardTimeout, marks its program unusable and drops the
    queue; completed work before it is forgotten."""
    marked = []
    first, wedged, behind = _Work(), _Work(), _Work()
    first.done = True
    guard._arm(first, 5.0, "ok")
    guard._arm(wedged, 0.15, "stuck", on_wedged=lambda: marked.append(1))
    guard._arm(behind, 5.0, "behind")
    guard.check_deadlines()  # not yet due: returns without waiting
    t0 = time.monotonic()
    with pytest.raises(GuardTimeout) as ei:
        guard.check_deadlines(wait=True)
    assert 0.1 <= time.monotonic() - t0 < 1.0
    assert ei.value.launched and "stuck" in str(ei.value)
    assert marked == [1] and guard.STATS.timeouts == 1
    guard.check_deadlines(wait=True)  # the queue was dropped


def test_device_deadline_kept_is_silent():
    """Work that completes before its deadline: the wait returns once it
    has, and the queue empties."""
    w = _Work()
    guard._arm(w, 5.0, "fine")
    threading.Timer(0.05, lambda: setattr(w, "done", True)).start()
    guard.check_deadlines(wait=True)
    assert w.done and not guard._queue()
    assert guard.STATS.timeouts == 0


def test_deadlines_handed_to_another_thread():
    """The serving fabric's handoff: work queued on one thread (a
    replica's dispatcher) is taken off its queue and kept on another (the
    fencer), where a stand-in event that never completes raises
    GuardTimeout at its deadline and marks its program; completed work
    handed over is silent, and the launching thread's queue is left
    empty."""
    marked, handed = [], []

    def launch():
        ok, wedged = _Work(), _Work()
        ok.done = True
        guard._arm(ok, 5.0, "fine")
        guard._arm(wedged, 0.15, "stuck", on_wedged=lambda: marked.append(1))
        handed.extend(guard.take_deadlines())
        handed.append(not guard._queue())

    th = threading.Thread(target=launch)
    th.start()
    th.join(timeout=10)
    assert handed[-1] is True  # the launching thread kept nothing
    deadlines = handed[:-1]
    guard.check_deadlines(wait=True)  # this thread's own queue: empty
    asked = []

    def query(event):
        asked.append(event)
        return event.query()

    t0 = time.monotonic()
    with pytest.raises(GuardTimeout) as ei:
        guard.wait_deadlines(deadlines, query)
    assert 0.1 <= time.monotonic() - t0 < 1.0
    assert ei.value.launched and "stuck" in str(ei.value)
    assert marked == [1] and guard.STATS.timeouts == 1
    assert asked and all(e is not None for e in asked)
    done = _Work()
    guard._arm(done, 5.0, "kept")
    threading.Timer(0.05, lambda: setattr(done, "done", True)).start()
    guard.wait_deadlines(guard.take_deadlines())
    assert done.done and guard.STATS.timeouts == 1
    guard.wait_deadlines([])  # nothing handed: returns at once


class _Gate:
    """A device's capture gate as the fence sees it: no answer (None)
    while ``open``, a capture segment being open on the device."""

    def __init__(self):
        self.open = True

    def __call__(self, event):
        return None if self.open else event.query()


def test_handed_deadline_raises_when_the_lock_is_held_past_it():
    """A capture that holds the device past the oldest deadline delays
    the fence's answer but does not stand for it: once the capture ends,
    work still pending raises GuardTimeout, as overdue as it is."""
    w = _Work()
    guard._arm(w, 0.15, "held")
    deadlines = guard.take_deadlines()
    gate = _Gate()
    t0 = time.monotonic()
    threading.Timer(0.4, lambda: setattr(gate, "open", False)).start()
    with pytest.raises(GuardTimeout) as ei:
        guard.wait_deadlines(deadlines, gate)
    assert 0.4 <= time.monotonic() - t0 < 1.5
    assert 0.2 <= ei.value.overdue_s < 1.4
    assert guard.STATS.timeouts == 1


def test_handed_deadline_outlived_by_a_capture_is_not_a_wedge():
    """A capture longer than the watchdog (a first call's build and
    capture on the device) keeps the fence from asking; work that
    completes meanwhile is seen once the capture ends, with no
    GuardTimeout and its program kept."""
    marked = []
    w = _Work()
    guard._arm(w, 0.1, "busy", on_wedged=lambda: marked.append(1))
    deadlines = guard.take_deadlines()
    gate = _Gate()
    t0 = time.monotonic()
    threading.Timer(0.2, lambda: setattr(w, "done", True)).start()
    threading.Timer(0.5, lambda: setattr(gate, "open", False)).start()
    guard.wait_deadlines(deadlines, gate)
    assert 0.5 <= time.monotonic() - t0 < 1.5
    assert w.done and not marked and guard.STATS.timeouts == 0


def test_handed_last_event_kept_under_the_last_deadline():
    """``last`` (a served batch's done event) is kept under the handed
    work's last deadline, with its program's ``on_wedged``; with nothing
    handed (the watchdog off) it is waited for without a deadline."""
    marked = []
    first, second, end = _Work(), _Work(), _Work()
    first.done = second.done = True
    guard._arm(first, 5.0, "first")
    guard._arm(second, 0.15, "second", on_wedged=lambda: marked.append(1))
    deadlines = guard.take_deadlines()
    t0 = time.monotonic()
    with pytest.raises(GuardTimeout) as ei:
        guard.wait_deadlines(deadlines, last=end)
    assert 0.1 <= time.monotonic() - t0 < 1.0
    assert "second" in str(ei.value) and marked == [1]
    late = _Work()
    threading.Timer(0.3, lambda: setattr(late, "done", True)).start()
    guard.wait_deadlines([], last=late)
    assert late.done and guard.STATS.timeouts == 1


def test_capture_gate_withholds_answers_while_a_segment_is_open():
    from pint_tpu_torch.runtime import graphs

    assert graphs.capture_gate("cpu") is None
    seg, w = graphs._Segments(), _Work()
    w.done = True
    assert seg.query(w) is True
    seg.opened()
    seg.opened()
    assert seg.query(w) is None
    seg.closed()
    assert seg.query(w) is None
    seg.closed()
    assert seg.query(w) is True


def test_guarded_dispatch_checks_earlier_deadlines_first():
    """A dispatch checks the work queued before it, without waiting: a
    missed deadline raises there, before the call launches, and is not
    retried."""
    calls = []
    wrapped = guard.dispatch_guard(lambda: calls.append(1), "next")
    guard._arm(_Work(), 0.0, "stuck")
    time.sleep(0.01)
    with guard.configured(dispatch_timeout=5.0, max_retries=2, **FAST):
        with pytest.raises(GuardTimeout):
            wrapped()
    assert calls == [] and guard.STATS.retries == 0


#: errors of the program itself whose text holds the reference's
#: transport markers: a kernel's nvcc log, CUDA launch and device errors,
#: a shape that names 413
KERNEL_ERRORS = [
    RuntimeError("CUDA build failed: fused_gram_joint.cu(413): error: "
                 "identifier \"q\" is undefined"),
    RuntimeError("CUDA error: the launch timed out and was terminated"),
    RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                 "unavailable"),
    RuntimeError("shape '[99413, 7]' is invalid for input of size 4"),
    TimeoutError("nvcc timed out"),
]


@pytest.mark.parametrize("err", KERNEL_ERRORS,
                         ids=["nvcc-413", "launch-timed-out", "unavailable",
                              "shape-413", "TimeoutError"])
def test_foreign_errors_propagate_unretried(err):
    """An error that is not the guard's own propagates at once, as it is:
    never retried, never turned into a TransportRejection (whatever
    classify_error reads in its text)."""
    calls = []

    def fail():
        calls.append(1)
        raise err

    with guard.configured(dispatch_timeout=5.0, max_retries=3, **FAST):
        with pytest.raises(type(err)) as ei:
            guard.guarded_call(fail, site="kernel")
    assert ei.value is err and calls == [1]
    assert guard.STATS.retries == 0
    assert guard.STATS.transport_rejections == 0


def test_abandoned_attempt_launches_nothing():
    """An attempt whose injected hang outlasts the watchdog raises at the
    deadline and never calls the function: only the retry runs it."""
    calls = []
    with guard.configured(dispatch_timeout=0.15, max_retries=1, **FAST):
        with faults.inject("hang:1", hang_seconds=0.4):
            assert guard.guarded_call(lambda: calls.append(1) or 7,
                                      site="abandon") == 7
    assert calls == [1]


def test_wedged_program_is_rebuilt():
    """An attempt that times out after it launched (a step whose host
    part ran past the deadline) drops its program; the retry builds a new
    one (a recompile)."""
    cache = ProgramCache("cpu")
    calls = []

    def step(x):
        calls.append(threading.current_thread())
        if len(calls) == 1:
            time.sleep(0.5)  # the wedge
        return x + 1

    prog = cache.program(step, ("wedge",))
    first = prog.program
    rec0 = obs_metrics.counter("compile.recompiles").value
    with guard.configured(compile_timeout=0.2, dispatch_timeout=0.2,
                          max_retries=1, **FAST):
        out = prog(torch.zeros(2))
    assert torch.equal(out, torch.ones(2))
    assert prog.program is not first
    assert obs_metrics.counter("compile.recompiles").value == rec0 + 1
    assert guard.STATS.timeouts == 1


def test_guard_bypassed_inside_torch_func():
    """Inside vmap (a PTA batch, a grid chunk) a guarded call passes
    straight through: no dispatch counted, no fault consumed."""
    wrapped = guard.dispatch_guard(lambda v: v * 2, "vmapped")
    with faults.inject("transient:1@vmapped"):
        out = torch.func.vmap(wrapped)(torch.ones(3, 2))
        assert torch.equal(out, 2 * torch.ones(3, 2))
        assert guard.STATS.dispatches == 0 and faults.active()
        with guard.configured(max_retries=1, **FAST):
            assert torch.equal(wrapped(torch.ones(2)), 2 * torch.ones(2))
    assert guard.STATS.dispatches == 1 and guard.STATS.retries == 1


# -- the finite validator + diagnosis ------------------------------------
def test_validate_finite_passes_clean_values():
    out = guard.validate_finite(
        {"x": np.ones(3), "chi2": 2.5, "skip": None}, site="ok")
    assert set(out) == {"x", "chi2"}


def test_validate_finite_refuses_nan_with_diagnosis():
    with pytest.raises(PintTpuNumericsError) as ei:
        guard.validate_finite(
            {"x": torch.tensor([1.0, float("nan")])}, site="s",
            what="unit step")
    assert ei.value.diagnosis is not None
    assert "docs/robustness.md" in str(ei.value)
    assert guard.STATS.numerics_errors == 1


def test_diagnosis_exponent_range_overflow():
    d = guard.diagnose_nonfinite(
        {"g": np.array([np.inf, 1e25]), "c": np.array([np.nan])}, "cpu")
    assert d.hazard == "exponent-range-overflow"
    assert "prescale" in d.hint


def test_diagnosis_subnormal_flush():
    d = guard.diagnose_nonfinite({"phi": np.array([4e-38, 0.0, np.nan])},
                                 "cuda")
    assert d.hazard == "subnormal-flush"
    assert "log space" in d.hint


def test_diagnosis_scalar_transcendental():
    d = guard.diagnose_nonfinite(
        {"roemer": np.float64(np.nan), "ok": np.ones(4)}, "cpu")
    assert d.hazard == "scalar-transcendental-path"
    assert "scalarmath" in d.hint


def test_injected_nan_poisons_only_the_validators_copy():
    vals = {"x": np.ones(4)}
    with faults.inject("nan:1"):
        with pytest.raises(PintTpuNumericsError):
            guard.validate_finite(vals, site="copytest")
    np.testing.assert_array_equal(vals["x"], np.ones(4))


# -- the degradation ladder ----------------------------------------------
def test_fit_rungs_shapes():
    """The reference's rung sequence without its host rung: the native
    mode, then f64, on the fit's own device."""
    assert fit_rungs("mixed", "cuda") == [("cuda-mixed", "mixed"),
                                          ("cuda-f64", "f64")]
    assert fit_rungs("f64", "cpu") == [("cpu-f64", "f64")]
    assert fit_rungs("qr", "cuda", f64_rung=False) == [("cuda-qr", "qr")]


def test_ladder_falls_through_and_records_history():
    served = []

    def rung(name, fail):
        def thunk(site):
            served.append(name)
            if fail:
                raise PintTpuNumericsError(f"{name} went NaN")
            return name

        return (name, thunk)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out, report = run_ladder(
            [rung("a", True), rung("b", True), rung("c", False)],
            site="unit")
    assert out == "c" and served == ["a", "b", "c"]
    assert report.rung == "c" and report.rung_index == 2
    assert report.fell_back
    assert [h[0] for h in report.history] == ["a", "b"]
    assert all("PintTpuNumericsError" in h[1] for h in report.history)
    assert [wi.category for wi in w] == [GuardTripWarning] * 2
    assert guard.STATS.fallbacks == 2
    assert obs_metrics.gauge("fallback.rung").value == 2


def test_ladder_exhausted_is_structured():
    def boom(site):
        raise GuardTimeout(site=site, timeout=1.0)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardTripWarning)
        with pytest.raises(LadderExhausted) as ei:
            run_ladder([("a", boom), ("b", boom)], site="allfail")
    assert [h[0] for h in ei.value.history] == ["a", "b"]
    assert "GuardTimeout" in ei.value.history[0][1]


def test_ladder_propagates_fatal_errors_immediately():
    calls = []

    def bad(site):
        calls.append(site)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        run_ladder([("a", bad), ("b", bad)], site="fatal")
    assert len(calls) == 1


# -- end-to-end: fitters on the CPU ---------------------------------------
@pytest.fixture(scope="module")
def gls_pulsar():
    m, toas = make_test_pulsar(PAR_RED, ntoa=64, seed=9, device="cpu")
    return m, toas


@pytest.fixture(scope="module")
def clean_f64(gls_pulsar):
    """The clean fit the f64 rung must reproduce."""
    m, toas = gls_pulsar
    f = GLSFitter(toas, m, fused=False, device="cpu")
    chi2 = _quiet(f.fit_toas)
    return f, chi2


def _gls(gls_pulsar, **kw):
    m, toas = gls_pulsar
    return GLSFitter(toas, m, device="cpu", **kw)


def test_gls_fit_nan_falls_back_identical(gls_pulsar, clean_f64):
    """A NaN on the native (mixed) rung: the fit lands on the f64 rung
    with the clean f64 fit's result — the loud-or-identical contract."""
    f0, chi0 = clean_f64
    f1 = _gls(gls_pulsar, fused="mixed")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faults.inject("nan:1@rung:cpu-mixed"):
            chi1 = f1.fit_toas()
    assert any(wi.category is GuardTripWarning for wi in w)
    assert f1.guard_report.fell_back
    assert f1.guard_report.rung == "cpu-f64"
    assert f1.guard_report.history[0][0] == "cpu-mixed"
    assert "PintTpuNumericsError" in f1.guard_report.history[0][1]
    assert chi1 == pytest.approx(chi0, rel=1e-12)
    np.testing.assert_allclose(f1.parameter_covariance_matrix,
                               f0.parameter_covariance_matrix, rtol=1e-9)


def test_gls_fit_ladder_exhausted_raises(gls_pulsar):
    f = _gls(gls_pulsar, fused="mixed")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardTripWarning)
        with faults.inject("nan:inf@rung:"):
            with pytest.raises(LadderExhausted) as ei:
                f.fit_toas()
    assert len(ei.value.history) == 2  # cpu-mixed then cpu-f64
    assert f.chi2 is None


def test_gls_fit_transient_retried_on_first_rung(gls_pulsar, clean_f64):
    _, chi0 = clean_f64
    f = _gls(gls_pulsar, fused=False)
    with guard.configured(max_retries=2, **FAST):
        with faults.inject("transient:1@cm.program"):
            chi1 = _quiet(f.fit_toas)
    assert guard.STATS.retries == 1
    assert not f.guard_report.fell_back
    assert chi1 == pytest.approx(chi0, rel=1e-12)


def test_gls_fit_wedged_dispatch_falls_to_next_rung(gls_pulsar, clean_f64):
    """Watchdog inside a real fit: the native rung's first dispatch
    wedges (simulated), times out, and the ladder serves the clean f64
    result from the next rung, on the same device."""
    _, chi0 = clean_f64
    _quiet(_gls(gls_pulsar, fused="mixed").fit_toas)  # warm the mixed path
    f = _gls(gls_pulsar, fused="mixed")
    with guard.configured(compile_timeout=0.6, dispatch_timeout=0.6,
                          max_retries=0, **FAST):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with faults.inject("hang:1@cm.program:gls/mixed",
                               hang_seconds=0.9):
                chi1 = f.fit_toas()
    assert f.guard_report.fell_back and f.guard_report.rung == "cpu-f64"
    assert "GuardTimeout" in f.guard_report.history[0][1]
    assert chi1 == pytest.approx(chi0, rel=1e-12)


def test_gls_fit_kernel_failure_is_not_served_by_f64(gls_pulsar,
                                                    monkeypatch):
    """A step whose kernel fails to build (an nvcc log naming line 413)
    fails the fit at once: no retry, no fallback, nothing served from the
    f64 rung."""
    err = KERNEL_ERRORS[0]
    steps = []

    def broken(*a, **kw):
        steps.append(1)
        raise err

    monkeypatch.setattr(GLSFitter, "_gn_step", broken)
    f = _gls(gls_pulsar, fused="mixed")
    with guard.configured(dispatch_timeout=5.0, compile_timeout=5.0,
                          max_retries=2, **FAST):
        with warnings.catch_warnings():
            warnings.simplefilter("error", GuardTripWarning)
            with pytest.raises(RuntimeError) as ei:
                f.fit_toas()
    assert ei.value is err and steps == [1]
    assert guard.STATS.retries == 0 and guard.STATS.fallbacks == 0
    assert f.guard_report is None and f.chi2 is None


def test_wls_fit_nan_raises_without_a_host_rung():
    """WLS has one rung (its solve is the f64 path); where the
    reference's fit falls to its host rung, the port's raises."""
    m, toas = make_test_pulsar(PAR_WHITE, ntoa=48, seed=3, device="cpu")
    f0 = WLSFitter(toas, m, device="cpu")
    chi0 = f0.fit_toas()
    f1 = WLSFitter(toas, m, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardTripWarning)
        with faults.inject("nan:1@rung:cpu-svd"):
            with pytest.raises(LadderExhausted) as ei:
                f1.fit_toas()
    assert [h[0] for h in ei.value.history] == ["cpu-svd"]
    assert f1.chi2 is None
    assert f1.fit_toas() == pytest.approx(chi0, rel=1e-12)


def test_downhill_proposal_nan_falls_back_to_f64(gls_pulsar):
    m, toas = gls_pulsar
    f0 = DownhillGLSFitter(toas, m, device="cpu")
    chi0 = _quiet(f0.fit_toas)
    assert f0.guard_report.rung == "native"
    f1 = DownhillGLSFitter(toas, m, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faults.inject("nan:1@downhill"):
            chi1 = f1.fit_toas()
    assert any(wi.category is GuardTripWarning for wi in w)
    assert f1.guard_report.rung == "f64-fallback"
    assert chi1 == pytest.approx(chi0, rel=1e-12)


def test_fit_toas_refuses_nan_with_diagnosis(gls_pulsar):
    """NaN TOA errors make the whole solve non-finite: every rung
    refused with the shared diagnosis, nothing committed."""
    m, toas = gls_pulsar
    bad = dict(toas, error_us=np.full_like(toas["error_us"], np.nan))
    fbad = GLSFitter(bad, m, fused="mixed", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(LadderExhausted) as ei:
            fbad.fit_toas()
    assert len(ei.value.history) == 2
    assert all("PintTpuNumericsError" in h[1] for h in ei.value.history)
    assert fbad.chi2 is None


def test_served_rung_matches_the_reference(ref):
    """The same 300-TOA pulsar (the reference's state carried across)
    under nan:inf on the native rung: the port serves the reference's
    rung index with the same history."""
    model, bundle = state_from_numpy(load_state(ref, "p300"),
                                     device="cpu")[:2]
    f = GLSFitter(bundle, model, fused="mixed", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardTripWarning)
        with faults.inject("nan:inf@rung:cpu-mixed"):
            chi2 = f.fit_toas()
    want = json.loads(str(ref["report"]))
    got = f.guard_report.to_dict()
    assert (got["rung"], got["rung_index"]) == (want["rung"],
                                                want["rung_index"])
    assert got["history"] == want["history"]
    assert chi2 == pytest.approx(float(ref["chi2"]), rel=1e-9)


# -- checkpoint resume after a mid-fit guard trip ------------------------
def test_checkpoint_resume_after_guard_trip(tmp_path, gls_pulsar):
    from pint_tpu_torch.checkpoint import load_fit, save_fit

    m, toas = gls_pulsar
    clean = GLSFitter(toas, m.clone(), fused=False, device="cpu")
    _quiet(clean.fit_toas)
    save_fit(tmp_path / "clean.npz", clean)
    tripped = GLSFitter(toas, m.clone(), fused="mixed", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inject("nan:1@rung:cpu-mixed"):
            tripped.fit_toas()
    assert tripped.guard_report.fell_back
    save_fit(tmp_path / "tripped.npz", tripped)
    b = load_fit(tmp_path / "tripped.npz")
    assert b["chi2"] == tripped.chi2
    np.testing.assert_array_equal(b["cov"],
                                  tripped.parameter_covariance_matrix)
    assert b["model"].as_parfile() == tripped.model.as_parfile()
    a = load_fit(tmp_path / "clean.npz")
    assert b["chi2"] == pytest.approx(a["chi2"], rel=1e-12)
    assert b["free_names"] == a["free_names"]
    assert b["converged"] == a["converged"]
    np.testing.assert_allclose(b["cov"], a["cov"], rtol=1e-9)
    resumed = GLSFitter(toas, b["model"], fused=False, device="cpu")
    chi2_resumed = _quiet(resumed.fit_toas)
    assert not resumed.guard_report.fell_back
    assert chi2_resumed == pytest.approx(a["chi2"], rel=1e-9)


# -- stats surface ---------------------------------------------------------
def test_stats_snapshot_keys():
    assert set(guard.STATS.snapshot()) == {
        "dispatches", "guarded", "retries", "timeouts",
        "transport_rejections", "numerics_errors", "fallbacks",
        "watchdog_margin_s", "watchdog_margin_frac",
    }


def test_guard_disabled_context(monkeypatch):
    """Inside guard.disabled() (and under PINT_TPU_GUARD=off) a call runs
    unguarded: faults don't fire, the guarded counter stays 0."""
    with faults.inject("transient:1"):
        with guard.disabled():
            wrapped = guard.dispatch_guard(lambda v: v + 1, "bypass")
            assert wrapped(1) == 2
        monkeypatch.setenv("PINT_TPU_GUARD", "off")
        assert wrapped(2) == 3
        monkeypatch.delenv("PINT_TPU_GUARD")
        assert guard.STATS.guarded == 0 and guard.STATS.dispatches == 2
        with guard.configured(max_retries=1, **FAST):
            assert guard.guarded_call(lambda: 7, site="drain") == 7


# -- retry copies of a program's own inputs (the reference's donation
# cases) ------------------------------------------------------------------
def test_retry_replays_a_copy_of_the_programs_own_inputs():
    """A caller passing the program's own input tensors: the guard copies
    them before an attempt that could be retried, so the retry reads the
    caller's values even where the failed attempt wrote into them; the
    copy counter is the observable, and arguments that are not the
    program's inputs pass through uncopied."""
    own = torch.arange(8.0, dtype=torch.float64) + 1.0
    want = own * 2.0 + 1.0
    calls = []

    def step(v):
        calls.append(1)
        v.mul_(3.0)  # an attempt that writes its static input ...
        if len(calls) == 1:  # ... then fails, transiently
            raise TransientDispatchError("reset after the copy-in")
        return v / 3.0 * 2.0 + 1.0

    snaps0 = obs_metrics.counter("guard.donation_snapshots").value
    # copies are taken where a retry can happen: a watchdog armed (here)
    # or a fault injected
    with guard.configured(dispatch_timeout=5.0, max_retries=2, **FAST):
        out = guard.guarded_call(
            step, (own,), site="own",
            snapshot=lambda args: guard.snapshot_inputs(args, [own]))
    assert torch.equal(out, want)
    assert obs_metrics.counter("guard.donation_snapshots").value > snaps0
    assert guard.STATS.retries == 1
    other = torch.ones(3)
    kept = guard.snapshot_inputs((own, other), [own])
    assert kept[0] is not own and torch.equal(kept[0], own)
    assert kept[1] is other


def test_retry_copy_skipped_on_quiet_steady_state():
    """No watchdog armed and no fault active: zero copies."""
    cache = ProgramCache("cpu")
    prog = cache.program(lambda v: v - 3.0, ("quiet",))
    snaps0 = obs_metrics.counter("guard.donation_snapshots").value
    with guard.configured(compile_timeout=None, dispatch_timeout=None,
                          **FAST):
        out = prog(torch.arange(4.0))
    assert torch.equal(out, torch.arange(4.0) - 3.0)
    assert obs_metrics.counter("guard.donation_snapshots").value == snaps0


def test_fence_owned_owns_its_bytes():
    t = torch.arange(512.0)
    fenced = guard.fence_owned({"a": (t, None)})
    arr = fenced["a"][0]
    assert arr.flags.owndata and fenced["a"][1] is None
    t.zero_()
    np.testing.assert_array_equal(arr, np.arange(512.0))


# -- on the card -------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("path", ["grid", "nested"])
def test_program_host_reads_poll_their_deadlines(monkeypatch, path):
    """The grid's and the nested sampler's host reads poll the deadlines
    their replays queued (``check_deadlines(wait=True)``), as the fit
    loops and ``run_ensemble`` do: a wedged replay raises GuardTimeout
    there, and no finished call stays queued on the thread, holding its
    program and the program's graph memory alive."""
    from pint_tpu_torch import bayesian, gridutils, nested

    mod = gridutils if path == "grid" else bayesian
    calls = []
    real = mod.check_deadlines
    monkeypatch.setattr(mod, "check_deadlines",
                        lambda wait=False: calls.append(wait) or real(wait))
    m, t = make_test_pulsar(PAR_WHITE, ntoa=64, seed=3, device="cpu")
    if path == "grid":
        f0 = float(m.params["F0"].value)
        gridutils.grid_chisq(t, m, {"F0": [f0 - 1e-11, f0, f0 + 1e-11]},
                             device="cpu")
    else:
        bt = bayesian.BayesianTiming(m, t, device="cpu")
        monkeypatch.setattr(
            nested, "nested_sample",
            lambda loglike, *a, **kw: loglike(np.zeros((3, bt.nparams))))
        bt.sample_nested(batch=4)
    assert calls == [True]


@pytest.mark.gpu
def test_card_refit_after_commit_captures_nothing():
    """On the card a fit's step program is captured once; the refit after
    its commit replays it (no capture, no build), and a program replayed
    after a commit equals a fresh model's fresh capture bitwise."""
    from pint_tpu_torch.fitting.gls import gauss_newton_step
    from pint_tpu_torch.runtime.graphs import StepProgram, flatten

    dev = _card()
    m, toas = make_test_pulsar(PAR_RED, ntoa=2048, seed=9, device=dev)
    f = GLSFitter(toas, m, device=dev)
    _quiet(f.fit_toas)
    caps = f.cm.programs.captures
    built = obs_metrics.counter("compile.traces").value
    _quiet(f.fit_toas)
    assert caps == 1 and f.cm.programs.captures == caps
    assert obs_metrics.counter("compile.traces").value == built
    cm = f.cm
    prog = cm.program(lambda x: gauss_newton_step(cm, x, "f64"), ("pa",))
    xn = prog(cm.x0())[0]
    cm.commit(xn.cpu().numpy())
    after, _ = flatten(prog(cm.x0()))
    fresh_cm = m.compile(toas, device=dev)
    fresh = StepProgram(lambda x: gauss_newton_step(fresh_cm, x, "f64"), dev)
    want, _ = flatten(fresh(fresh_cm.x0()))
    assert all(torch.equal(a, b) for a, b in zip(after, want))


@pytest.mark.gpu
def test_card_guard_retries_and_abandons_without_launching():
    """On the card the watchdog is armed by default; a transient fault is
    retried, and a replay whose attempt hangs past the watchdog is
    retried while the abandoned attempt launches nothing."""
    from pint_tpu_torch.ops import fused_gram

    dev = _card()
    assert guard.current_config("cuda").dispatch_timeout == 900.0
    m, toas = make_test_pulsar(PAR_RED, ntoa=2048, seed=9, device=dev)
    f = GLSFitter(toas, m, device=dev)
    chi0 = _quiet(f.fit_toas)
    with guard.configured(max_retries=2, **FAST):
        with faults.inject("transient:2@cm.program"):
            chi1 = _quiet(f.fit_toas)
    assert guard.STATS.retries == 2 and np.isfinite(chi1) and np.isfinite(chi0)
    assert f.guard_report.rung == "cuda-mixed"
    reps = f.cm.programs.replays
    n0 = fused_gram.fused_gram_joint_cuda.launches
    with guard.configured(compile_timeout=60.0, dispatch_timeout=0.3,
                          max_retries=1, **FAST):
        with faults.inject("hang:1@cm.program", hang_seconds=0.6):
            _quiet(f.fit_toas)
    torch.cuda.synchronize()
    assert guard.STATS.timeouts == 1
    steps = f.cm.programs.replays - reps
    assert fused_gram.fused_gram_joint_cuda.launches - n0 == steps


@pytest.mark.gpu
def test_card_device_wedge_seen_at_the_host_read():
    """A guarded call whose kernel spins past its deadline: the host
    read's wait ends in GuardTimeout at the deadline, not when the kernel
    ends, and the call's program is marked unusable."""
    _card()
    marked = []
    spin = guard.dispatch_guard(lambda: torch.cuda._sleep(2_000_000_000),
                                "spin", device_type="cuda",
                                on_wedged=lambda: marked.append(1))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with guard.configured(compile_timeout=0.2, dispatch_timeout=0.2,
                          max_retries=0):
        spin()
        with pytest.raises(GuardTimeout):
            guard.check_deadlines(wait=True)
    seen = time.monotonic() - t0
    torch.cuda.synchronize()
    assert 0.2 <= seen < time.monotonic() - t0
    assert marked == [1] and guard.STATS.timeouts == 1


@pytest.mark.gpu
def test_card_grid_leaves_no_deadline_queued():
    """On the card: after ``grid_chisq`` returns, nothing it launched
    stays queued under a deadline on the calling thread, so its program
    (and the program's graph pool) goes with its compiled model."""
    import gc

    from pint_tpu_torch.gridutils import grid_chisq

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    m, t = make_test_pulsar(PAR_WHITE, ntoa=2048, seed=3, device="cpu")
    f0 = float(m.params["F0"].value)
    guard.check_deadlines(wait=True)
    grid_chisq(t, m, {"F0": [f0 - 1e-11, f0, f0 + 1e-11]}, device="cuda")
    assert not getattr(guard._pending, "q", None)
    gc.collect()
    assert not [c for c in gc.get_objects() if isinstance(c, ProgramCache)
                and any(k[0] == "grid" for k in c._programs)]


@pytest.mark.gpu
def test_card_spinning_kernel_seen_by_a_fence_thread():
    """The serving fabric's handoff on the card: a kernel spinning past
    its deadline, launched on one thread and its deadlines handed to a
    fence thread, which raises GuardTimeout at the deadline (not when the
    kernel ends) while asking through the device's capture gate."""
    from pint_tpu_torch.runtime.graphs import capture_gate

    dev = _card()
    marked, seen = [], {}
    spin = guard.dispatch_guard(lambda: torch.cuda._sleep(2_000_000_000),
                                "spin", device_type="cuda",
                                on_wedged=lambda: marked.append(1))
    torch.cuda.synchronize()
    with guard.configured(compile_timeout=0.2, dispatch_timeout=0.2,
                          max_retries=0):
        t0 = time.monotonic()
        spin()
        deadlines = guard.take_deadlines()

        def fence():
            try:
                guard.wait_deadlines(deadlines, capture_gate(dev))
            except GuardTimeout as e:
                seen["raised"] = e
            seen["at"] = time.monotonic() - t0

        th = threading.Thread(target=fence)
        th.start()
        th.join(timeout=30)
    torch.cuda.synchronize()
    spun = time.monotonic() - t0
    assert isinstance(seen.get("raised"), GuardTimeout)
    assert 0.2 <= seen["at"] < spun
    assert marked == [1] and guard.STATS.timeouts == 1
