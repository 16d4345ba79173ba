"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell, configuration or metric needs is found by name under
the benchmark's folder: ``cells/<cell>.json``, ``configs/<config>.json``
and ``metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None).  ``BENCHMARK.json`` at the checkout's root says which metrics a
cell reports.  The window is a closed loop of one user refitting one
pulsar: before each fit the model is put back at the cell's starting
values, the fitter entry runs, and the fitted parameters, their
covariance and chi2 come back to the host.  The window closes at the end
of the first fit that ends after ``seconds``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare
from portbench.inputs.simulate import simulate, start_par

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: fits before the window: the first builds and captures the step
#: program, the second runs as the window's fits do
WARMUP_FITS = 2
#: fits traced after the window in a ``--trace 1`` run
TRACE_FITS = 3


# -- finding cells, configurations and metrics by name --------------------
def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell file with its configuration file under ``"config"``."""
    cell = load_json("cells", name, root)
    cell["name"] = name
    cell["config"] = dict(load_json("configs", cell["config"], root),
                          name=cell["config"])
    return cell


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no metric reader named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries of BENCHMARK.json a run of ``cell`` reports:
    the end-to-end ones with ``trace`` off, the per-layer ones with it
    on; an entry without ``workloads`` belongs to every cell (a per-layer
    one, to every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


# -- the run's record, which the metric readers read ------------------------
@dataclass
class Run:
    cell: str
    ntoa: int
    shape: dict  # n, k, p1 (design columns with the offset, + residual)
    full_cov: bool
    setup_s: float = math.nan
    window_s: float = math.nan
    fit_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    peak_bytes: int = 0
    trace: object = None  # portbench.trace.Trace of the traced fits
    #: nvcc processes the run started (the port's ``NVCC_RUNS``): 0 but
    #: in a checkout's first run, whose set-up then holds the build
    kernel_builds: int = 0
    device: dict = field(default_factory=dict)


# -- the program side -------------------------------------------------------
def _delta(value, start) -> float:
    """value - start of one parameter's internal value, in float64: a
    float, a double-double (``.hi``/``.lo``) or an epoch (day, seconds)."""
    if isinstance(value, tuple):
        return ((float(value[0]) - float(start[0])) * 86400.0
                + _delta(value[1], start[1]))
    if hasattr(value, "hi"):
        return ((float(value.hi) - float(start.hi))
                + (float(value.lo) - float(start.lo)))
    return float(value) - float(start)


class Program:
    """The system under test: one fitter of the cell's entry, and the
    model put back at the starting values before each fit."""

    def __init__(self, par: str, table: dict, cell: dict, device: str):
        from pint_tpu_torch.fitting.gls import GLSFitter
        from pint_tpu_torch.models.builder import get_model

        self.fitter = GLSFitter(table, get_model(par),
                                full_cov=cell["fitter"]["full_cov"],
                                device=device)
        self.maxiter = cell["fitter"]["maxiter"]
        self.tol_chi2 = cell["fitter"]["tol_chi2"]
        self.names = list(self.fitter.cm.free_names)
        params = get_model(par).params
        self.start = [params[n].internal() for n in self.names]

    def _internal(self):
        params = self.fitter.model.params
        return [params[n].internal() for n in self.names]

    def reset(self):
        now = self._internal()
        self.fitter.cm.commit(np.array([_delta(s, v) for s, v in
                                        zip(self.start, now)]))

    def fit(self):
        """Reset, fit, and the answer as the host has it: (internal
        values, covariance, chi2, served by a fallback rung)."""
        with record_function("portbench.reset"):
            self.reset()
        f = self.fitter
        with record_function("portbench.fit_toas"):
            f.fit_toas(maxiter=self.maxiter, tol_chi2=self.tol_chi2)
        return (self._internal(), f.parameter_covariance_matrix, f.chi2,
                f.guard_report.fell_back)

    def answer(self, raw) -> dict:
        values, cov, chi2, _ = raw
        return {"names": self.names,
                "x": np.array([_delta(v, s) for v, s in
                               zip(values, self.start)]),
                "cov": np.asarray(cov), "chi2": float(chi2)}

    def step_inputs(self) -> dict:
        """The step's inputs at the starting values, from the fitter's own
        hooks at full size (residuals, design matrix with its offset,
        the scaled sigma, the noise basis and its weights), on the
        host."""
        self.reset()
        f = self.fitter
        x0 = f.cm.x0()
        r, M, ndiag = f._step_inputs(x0)
        T, phi = f._step_noise(x0)
        host = {k: v.detach().cpu().numpy() for k, v in
                (("r", r), ("M", M), ("sigma", torch.sqrt(ndiag)),
                 ("T", T), ("phi", phi))}
        return dict(host, names=self.names)

    def counters(self) -> dict:
        from pint_tpu_torch.ops import fused_gram

        progs = self.fitter.cm.programs
        k = fused_gram.fused_gram_joint_cuda
        return {"replays": progs.replays, "captures": progs.captures,
                "gram_launches": getattr(k, "launches", 0)}

    def shape(self) -> dict:
        cm = self.fitter.cm
        T, _ = cm.noise_basis_or_empty(cm.x0())
        p1 = cm.nfree + 1 + 1  # offset, parameters, residual column
        return {"n": cm.bundle.ntoa, "k": int(T.shape[1]), "p1": p1,
                "nfree": cm.nfree}


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def device_info(device) -> dict:
    if not _on_card(device):
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        limit = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit_w": limit}


def _kernel_builds() -> int:
    from pint_tpu_torch.ops import _cuda_build

    return _cuda_build.NVCC_RUNS


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None, log=print) -> dict:
    """One run: set-up, window, (trace), the check; -> the result dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = cell["config"]
    stages = [("imports", time.perf_counter())]
    truth, table = simulate(cfg, seed)
    par = start_par(truth, cell["start"]["offsets"], seed)
    stages.append(("simulate", time.perf_counter()))
    prog = Program(par, table, cell, device)
    stages.append(("build", time.perf_counter()))
    answers = []
    for i in range(WARMUP_FITS):
        answers.append(prog.fit())
        stages.append((f"warm-up fit {i + 1}", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {t - (stages[i - 1][1] if i else t_start):.3f} s"
        for i, (name, t) in enumerate(stages)), file=sys.stderr)
    run = Run(cell=cell["name"], ntoa=len(table["freq_mhz"]),
              shape=prog.shape(), full_cov=cell["fitter"]["full_cov"],
              device=device_info(device))
    setup_peak = 0
    if _on_card(device):
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    run.kernel_builds = _kernel_builds()
    log(f"set-up: {run.setup_s:.3f} s, {run.kernel_builds} kernel builds "
        "(nvcc) in it", file=sys.stderr)

    # -- the measured window
    c0 = prog.counters()
    attempted = failed = fallbacks = 0
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        attempted += 1
        try:
            raw = prog.fit()
        except Exception as exc:  # a failed fit counts, the loop goes on
            failed += 1
            log(f"fit {attempted} failed: {type(exc).__name__}: {exc}",
                file=sys.stderr)
        else:
            answers.append(raw)
            fallbacks += raw[3]
        t2 = time.perf_counter()
        run.fit_s.append(t2 - t1)
        if t2 - t0 >= seconds:
            break
    run.window_s = t2 - t0
    c1 = prog.counters()
    run.counters = {k: c1[k] - c0[k] for k in c0}
    run.counters.update(fits=attempted, fallback_fits=fallbacks,
                        failed=failed)
    if _on_card(device):
        # graph replays allocate nothing: the set-up's captures hold
        # the step's memory, so the run's peak is the one that counts
        run.peak_bytes = max(setup_peak, torch.cuda.max_memory_allocated())
    peak = run.peak_bytes

    if trace:
        from portbench import trace as tracing

        run.trace = tracing.trace_fits(
            lambda: answers.append(prog.fit()), TRACE_FITS,
            prog.counters)

    # the program's state goes before the reference runs
    inputs = prog.step_inputs()
    got = [prog.answer(a) for a in answers]
    del prog
    if _on_card(device):
        gc.collect()
        torch.cuda.empty_cache()

    checks = compare.check(par, table, got, cell["limits"],
                           cell["fitter"]["maxiter"], inputs)
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    bench = bench or json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {k: run.device[k] for k in ("platform", "kind", "count")}
    dev["memory_peak_bytes"] = int(peak)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["power_limit_w"] = run.device.get("power_limit_w")
    out["kernel_builds"] = run.kernel_builds
    out["checks"] = checks
    return out

