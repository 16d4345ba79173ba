"""compare_parfiles: parameter-level diff of two models.

Reference parity: src/pint/scripts/compare_parfiles.py (wraps
TimingModel.compare).  Nothing is evaluated, so ``--device`` is only
checked.
"""

from __future__ import annotations

import argparse

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description="Compare two par files")
    ap.add_argument("par1")
    ap.add_argument("par2")
    ap.add_argument("--log-level", default="WARNING")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    plog.setup(args.log_level)

    from pint_tpu_torch.device import resolve_device
    from pint_tpu_torch.models.builder import get_model

    resolve_device(args.device)
    m1 = get_model(args.par1)
    m2 = get_model(args.par2)
    print(f"{'PARAM':<12} {args.par1:>25} {args.par2:>25}")
    print(m1.compare(m2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
