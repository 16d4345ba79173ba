"""Phase 13 of ``chip_smoke.py`` alone, on one CUDA card: the timing
posterior on bench.py's pulsar (the batched log-posterior, an MCMCFitter
fit, nested sampling), the chi2 grid over M2 x SINI on the binary MSP and
the photon template fit, with every gate of the phase.

    python3 profiling/torch_inference.py [--ntoa N] [--steps S]
        [--only bench|grid|photons ...] [--out FILE]

``--ntoa`` cuts both pulsars (default 1e5, the script's size) for a
quick first call; ``--steps`` sets the MCMC fit's steps; ``--only``
runs the named parts.  The JSON result goes to stdout's last line and,
with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar, msp_par  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntoa", type=int, default=cs.NTOA)
    ap.add_argument("--steps", type=int, default=cs.INF_STEPS)
    ap.add_argument("--only", nargs="*", default=["bench", "grid",
                                                  "photons"])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_inference: no CUDA device", file=sys.stderr)
        return 2
    cs.NTOA, cs.INF_STEPS = args.ntoa, args.steps
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    if "bench" in args.only:
        out["bench"] = cs.bench_inference(dev)
    if "grid" in args.only:
        _, msp_toas = make_test_pulsar(msp_par(cs.MSP_NDMX, seed=0),
                                       ntoa=cs.NTOA, device=dev,
                                       **cs.MSP_SIM)
        out["grid"] = cs.grid_inference(dev, msp_toas)
    if "photons" in args.only:
        cs.zero_counts()
        out["photons"] = cs.photon_inference(dev)
        out["photon_launches"] = cs.inference_launches("LCFitter")
    out["seconds"] = time.perf_counter() - t0
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
