"""tcb2tdb: convert a TCB par file to TDB.

Reference parity: src/pint/scripts/tcb2tdb.py (wraps
models/tcb_conversion.py).  The conversion is host arithmetic, so
``--device`` is only checked.
"""

from __future__ import annotations

import argparse

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert TCB par to TDB")
    ap.add_argument("input_par")
    ap.add_argument("output_par")
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.device import resolve_device
    # get_model converts the parameters when UNITS is TCB
    from pint_tpu_torch.models.builder import get_model

    resolve_device(args.device)
    model = get_model(args.input_par)
    with open(args.output_par, "w") as f:
        f.write(model.as_parfile())
    units = model.top_params.get("UNITS")
    log.info("wrote %s (UNITS %s)", args.output_par,
             units.value if units is not None else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
