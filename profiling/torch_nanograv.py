"""Phase 21 of ``chip_smoke.py`` alone, on one CUDA card: the reference's
NANOGrav configurations (BASELINE.json configs 2 and 3) at their size —
a J1713+0747-like DD binary with ECORR and red noise at 10,000 TOAs
through ``auto_fitter``, and the binary MSP with ECORR and red noise at
8192 TOAs by ``GLSFitter`` with the Woodbury and the dense step, each on
its native and on its f64 rung — with every gate of the phase.

    python3 profiling/torch_nanograv.py [--out FILE]

It builds the kernels first.  The JSON result goes to stdout's last line
and, with ``--out``, to FILE.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_nanograv: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.build_libraries(cs.LIBRARIES)
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    out = cs.nanograv_phase(torch.device("cuda"))
    line = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
