"""pintpublish: publication-style parameter table from a par/tim pair.

Reference parity: src/pint/scripts/pintpublish.py: fit on ``--device``
and print a LaTeX (or plain-text) table of measured and derived
quantities.
"""

from __future__ import annotations

import argparse

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Generate a publication parameter table"
    )
    ap.add_argument("parfile")
    ap.add_argument("timfile")
    ap.add_argument("--latex", action="store_true")
    ap.add_argument("--log-level", default="WARNING")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    plog.setup(args.log_level)

    from pint_tpu_torch.fitting import auto_fitter
    from pint_tpu_torch.models.builder import get_model_and_toas

    model, toas = get_model_and_toas(args.parfile, args.timfile)
    fitter = auto_fitter(toas, model, device=args.device)
    fitter.fit_toas()
    rr = fitter.resids
    r = rr.toa if hasattr(rr, "toa") else rr

    rows = [
        ("Pulsar name", model.name or "", ""),
        ("MJD range", f"{toas.first_mjd():.1f}-{toas.last_mjd():.1f}", ""),
        ("Number of TOAs", str(len(toas)), ""),
        ("Weighted RMS residual (us)",
         f"{r.rms_weighted() * 1e6:.3f}", ""),
        ("Reduced chi2", f"{r.reduced_chi2:.3f}", ""),
    ]
    for n in fitter.cm.free_names:
        p = model.params[n]
        unc = (
            f"{p.uncertainty:.2e}" if p.uncertainty is not None else ""
        )
        rows.append((n, p._format_value(), unc))
    # derived quantities when the spin parameters allow
    try:
        from pint_tpu_torch import derived_quantities as dq

        f0 = float(model.params["F0"].value.to_float())
        f1 = float(model.params["F1"].value)
        rows.append(
            ("Characteristic age (yr)", f"{dq.pulsar_age(f0, f1):.3e}", "")
        )
        rows.append(
            ("Surface B field (G)", f"{dq.pulsar_B(f0, f1):.3e}", "")
        )
    except (KeyError, AttributeError, TypeError):
        pass

    if args.latex:
        print("\\begin{tabular}{lll}")
        print("\\hline Parameter & Value & Uncertainty \\\\ \\hline")
        for name, val, unc in rows:
            print(f"{name} & {val} & {unc} \\\\")
        print("\\hline \\end{tabular}")
    else:
        width = max(len(r[0]) for r in rows) + 2
        for name, val, unc in rows:
            print(f"{name:<{width}}{val:>28}  {unc}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
