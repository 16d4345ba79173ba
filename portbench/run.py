"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the cell's inputs simulated from the seed, the model
built, kernels built and step programs captured, warm-up fits), then the
measured window of ``--seconds``, with ``--trace 1`` a few traced fits
after it, then the check against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced),
with ``checks`` last: each number compared beside its limit, which the
last lines of standard error repeat.  Without a CUDA card, or when the
process holds ``jax``, ``jaxlib``, ``flax`` or ``pint_tpu`` at its end,
it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
#: modules the process must not hold, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pint_tpu")
#: the thread pools of torch and of numpy's BLAS, each held to one thread
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one host thread for the program and the reference: the host is
    # shared, and a process that needs all its cores at each sync point
    # is slowed by every other tenant (on an H100 host, the default
    # thread pools spread fit_toas_per_s by 3-4% from run to run)
    for var in THREAD_VARS:
        os.environ[var] = "1"
    # every cache of the run at a fixed path inside the checkout
    cache = CHECKOUT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from portbench import harness

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
