"""Readings that set a cell's limits (run on the card, not by the runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--out file.jsonl]

For each seed, in one process: the cell's inputs, the program's answer
from the cell's fitter entry at the cell's size (after the warm-up fit,
as the window's fits are) and its step inputs at the starting values,
and their six numbers against the float64 reference
(``portbench/compare.py``).  For each control seed: the control, which
is the reference put in the program's place in the precision below the
configuration's (the step's linear algebra, the design matrix and the
noise model in float32, the spin phase in float64 where the
configuration's is double-double), and four faults planted in the
reference: the state left unchanged (the starting values returned),
half of the TOAs left out (every other row), an answer altered where it
is produced (the first parameter moved by one of its uncertainties), and
one design column scaled by 1.1.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def _rows(table: dict, idx) -> dict:
    out = {}
    for k, v in table.items():
        out[k] = [v[i] for i in idx] if isinstance(v, list) else v[idx]
    return out


def residuals_f64(model, x):
    """The reference's residuals with the spin phase in float64 (not
    double-double): the control's residuals."""
    import numpy as np

    v = model.values(x)
    dt = (model.dt_pep - model.delay(v)).to_float()
    f0 = v["F0"].to_float()
    jump = sum(v[n] * model.mask(n) for n in model._family("JUMP"))
    ph = dt * (f0 + dt * (0.5 * v["F1"])) - jump * f0
    return (ph - np.round(ph)) / model.spin_frequency(v)


def control_inputs(par, table, ref) -> dict:
    import numpy as np

    from portbench.reference.model import ReferenceModel

    model = ReferenceModel(par, table)
    f32 = {k: ref["inputs"][k].astype(np.float32).astype(np.float64)
           for k in ("M", "sigma", "T", "phi")}
    return dict(f32, names=ref["names"],
                r=residuals_f64(model, np.zeros(len(ref["names"]))))


def faults(par, table, ref, steps) -> dict:
    import numpy as np

    from portbench.compare import gaps, input_gaps, reference_fit

    sig = np.sqrt(np.diag(ref["cov"]))
    unchanged = dict(ref, x=np.zeros_like(ref["x"]))
    altered = dict(ref, x=ref["x"] + np.eye(len(sig))[0] * sig[0])
    half = reference_fit(par, _rows(table, np.arange(0, len(
        table["freq_mhz"]), 2)), steps)
    scaled = dict(ref["inputs"], names=ref["names"])
    scaled["M"] = scaled["M"].copy()
    scaled["M"][:, 1] *= 1.1
    return {"unchanged": gaps(unchanged, ref), "half": gaps(half, ref),
            "altered": gaps(altered, ref),
            "column_scaled": input_gaps(scaled, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import numpy as np

    from portbench import harness
    from portbench.compare import gaps, input_gaps, reference_fit
    from portbench.inputs.simulate import simulate, start_par

    cell = harness.load_cell(args.workload)
    steps = cell["fitter"]["maxiter"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        truth, table = simulate(cell["config"], seed)
        par = start_par(truth, cell["start"]["offsets"], seed)
        ref = reference_fit(par, table, steps)
        rec = {"cell": args.workload, "seed": seed,
               "sigma": dict(zip(ref["names"],
                                 np.sqrt(np.diag(ref["cov"])).tolist())),
               "start_sigma": float(np.max(np.abs(ref["x"]) / np.sqrt(
                   np.diag(ref["cov"]))))}
        if seed in args.seeds:
            prog = harness.Program(par, table, cell, args.device)
            prog.fit()
            raw = prog.fit()
            rec["program"] = dict(gaps(prog.answer(raw), ref),
                                  **input_gaps(prog.step_inputs(), ref))
            rec["steps"] = prog.fitter.steps_taken
            rec["fell_back"] = bool(raw[3])
            del prog, raw
            gc.collect()
        if seed in args.control_seeds:
            ctrl = reference_fit(par, table, steps, dtype=np.float32)
            rec["control"] = dict(gaps(ctrl, ref), **input_gaps(
                control_inputs(par, table, ref), ref))
            rec["faults"] = faults(par, table, ref, steps)
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
