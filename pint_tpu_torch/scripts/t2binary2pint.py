"""t2binary2pint: normalize tempo2 T2-model par files.

Reference parity: src/pint/scripts/t2binary2pint.py: tempo2's catch-all
'BINARY T2' model is a parameter-dependent union; map it to the concrete
model family the port implements: ELL1 variants when EPS1/EPS2/TASC are
present (ELL1H with H3), DD variants otherwise (DDH with H3/STIGMA, DDK
with KIN/KOM, DDS with SHAPMAX, else DD).  Nothing is evaluated, so
``--device`` is only checked.
"""

from __future__ import annotations

import argparse

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def t2_binary_target(params: set) -> str:
    if "EPS1" in params or "TASC" in params:
        return "ELL1H" if "H3" in params else "ELL1"
    if "KIN" in params and "KOM" in params:
        return "DDK"
    if "SHAPMAX" in params:
        return "DDS"
    if "H3" in params and ("STIG" in params or "STIGMA" in params):
        return "DDH"
    return "DD"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a tempo2 BINARY T2 par file"
    )
    ap.add_argument("input_par")
    ap.add_argument("output_par")
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.device import resolve_device
    from pint_tpu_torch.io.par import parse_parfile
    from pint_tpu_torch.models.builder import get_model

    resolve_device(args.device)
    pardict = parse_parfile(args.input_par)
    binary = pardict.get("BINARY", [["none"]])[0][0].upper()
    if binary != "T2":
        log.info("BINARY %s needs no conversion; validating only", binary)
        out_text = get_model(args.input_par).as_parfile()
    else:
        target = t2_binary_target(set(pardict))
        log.info("BINARY T2 -> %s", target)
        lines = []
        with open(args.input_par) as f:
            for line in f:
                toks = line.split()
                if toks and toks[0].upper() == "BINARY":
                    line = f"BINARY {target}\n"
                lines.append(line)
        out_text = get_model("".join(lines)).as_parfile()
    with open(args.output_par, "w") as f:
        f.write(out_text)
    log.info("wrote %s", args.output_par)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
