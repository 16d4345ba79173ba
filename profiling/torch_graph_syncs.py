"""The host syncs inside each step a fit captures, and its capture.

    python3 profiling/torch_graph_syncs.py [--pta N]

For each function the fit loops run as step programs
(``runtime/graphs.py``) at 1e5 TOAs — bench.py's pulsar's mixed, f64 and
fourier GLS steps, the binary MSP's mixed and f64 steps, one downhill GLS
iteration on bench.py's pulsar, one downhill WLS (QR) iteration on the
white MSP, and the PTA batch's mixed and f64 steps (N pulsars of
``pta_pars``, default 45) — runs one eager call after a warm-up under
``torch.cuda.set_sync_debug_mode("warn")`` and lists every synchronizing
operation by its Python call site, then captures the function as a step
program, replays it twice and checks the replays bitwise equal to the
eager call.  Prints the linalg backend setting, one line per function,
one JSON line, then the card's name and power limit.  A capture that
fails is reported and the next function is tried.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pint_tpu_torch.fitting import (  # noqa: E402
    DownhillGLSFitter,
    DownhillWLSFitter,
    GLSFitter,
)
from pint_tpu_torch.ops._cuda_build import build_libraries  # noqa: E402
from pint_tpu_torch.parallel.pta import PTABatch  # noqa: E402
from pint_tpu_torch.runtime import graphs  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
    pta_ntoas,
    pta_pars,
)

BENCH_PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
RAJ              17:44:29.403209    1
DECJ             -11:34:54.68067    1
EFAC             -f L-wide 1.1
EQUAD            -f L-wide 0.5
TNREDAMP         -13.5
TNREDGAM         3.7
TNREDC           30
"""
NTOA = 100_000
SIM = dict(start_mjd=53000.0, end_mjd=57500.0, seed=0, iterations=1,
           orbit=True)
MSP_SIM = dict(SIM, freqs=MSP_FREQS, orbit_in_phase=True)


def syncs(fn, args):
    """Call sites of the synchronizing operations of one eager call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}"
            sites[where] = sites.get(where, 0) + 1
    if sites:
        # the first one's whole call chain, from the error it raises
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args)
        except RuntimeError:
            frames = traceback.extract_tb(sys.exc_info()[2])
            sites["first"] = [f"{Path(fr.filename).name}:{fr.lineno} "
                              f"{fr.name}" for fr in frames[-8:]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def probe(label, fn, args):
    """Warm up, list the syncs, capture, replay twice, compare."""
    out = dict(label=label)
    try:
        eager = fn(*args)
        out["syncs"] = syncs(fn, args)
        eager = graphs.flatten(fn(*args))[0]
        prog = graphs.StepProgram(fn, args[0].device)
        first = graphs.flatten(prog(*args))[0]
        again = graphs.flatten(prog(*args))[0]
        torch.cuda.synchronize()
        out.update(
            segments=len(prog.segments), capture_s=prog.capture_s,
            pool_reserved=prog.pool_reserved,
            bitwise=all(torch.equal(e, g) and torch.equal(g, g2)
                        for e, g, g2 in zip(eager, first, again)))
        del prog
    except Exception as e:  # report, and go on to the next function
        out["error"] = f"{type(e).__name__}: {e}"
        out["trace"] = traceback.format_exc(limit=6)[-1500:]
    print(f"{label}: {out}", flush=True)
    return out


def white_par(ndmx):
    return "".join(ln + "\n" for ln in msp_par(ndmx, seed=0).splitlines()
                   if not ln.startswith("TNRED"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pta", type=int, default=45)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_graph_syncs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; linalg "
          f"backend {torch.backends.cuda.preferred_linalg_library()}",
          flush=True)
    build_libraries(["fused_gram_joint", "fused_gram_wide", "fourier_gram",
                     "fourier_apply"])
    res = []
    model, toas = make_test_pulsar(BENCH_PAR, ntoa=NTOA, device=dev, **SIM)
    f = GLSFitter(toas, model, device=dev)
    x = f.cm.x0()
    for mode in ("mixed", "f64", "fourier"):
        res.append(probe(f"bench {mode} step",
                         lambda x, m=mode: f._gn_step(x, m), (x,)))
    false = torch.zeros((), dtype=torch.bool, device=dev)
    d = DownhillGLSFitter(toas, model, device=dev)
    it, _, chi2_fn = d._make_iteration(False, 1e-2, 1e-2, 1e-3)
    res.append(probe("bench downhill GLS iteration", it,
                     (x, chi2_fn(x), false, false)))
    del f, d, it

    model, toas = make_test_pulsar(msp_par(150, seed=0), ntoa=NTOA,
                                   device=dev, **MSP_SIM)
    f = GLSFitter(toas, model, device=dev)
    x = f.cm.x0()
    for mode in ("mixed", "f64"):
        res.append(probe(f"msp {mode} step",
                         lambda x, m=mode: f._gn_step(x, m), (x,)))
    del f
    model, toas = make_test_pulsar(white_par(150), ntoa=NTOA, device=dev,
                                   **MSP_SIM)
    w = DownhillWLSFitter(toas, model, device=dev)
    it, _, chi2_fn = w._make_iteration(False, 1e-2, 1e-2, 1e-3)
    x = w.cm.x0()
    res.append(probe("white msp downhill WLS iteration", it,
                     (x, chi2_fn(x), false, false)))
    del w, it

    ntoas = pta_ntoas(a.pta, seed=0, nmin=4000, nmax=10_000)
    cms = [make_test_pulsar(par, ntoa=int(n), device=dev,
                            **{**MSP_SIM, "seed": i})
           for i, (par, n) in enumerate(zip(pta_pars(a.pta, 100, seed=0),
                                            ntoas))]
    batch = PTABatch([m.compile(t, device=dev) for m, t in cms])
    for mode in ("mixed", "f64"):
        res.append(probe(f"pta {mode} step ({a.pta} pulsars)",
                         batch._step_fn(mode), (batch.x0(),)))
    print(json.dumps({"graph_syncs": [{k: v for k, v in r.items()
                                       if k != "trace"} for r in res]}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if all("error" not in r and r["bitwise"] for r in res) else 1


if __name__ == "__main__":
    sys.exit(main())
