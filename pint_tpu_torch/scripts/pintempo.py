"""pintempo: tempo2-style command-line fit.

Reference parity: src/pint/scripts/pintempo.py: load par + tim, pick a
fitter, fit on ``--device``, print the summary, optionally plot the
residuals and write the fitted par file.
"""

from __future__ import annotations

import argparse

import numpy as np

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fit a timing model to TOAs (pintempo)"
    )
    ap.add_argument("parfile")
    ap.add_argument("timfile")
    ap.add_argument("--fitter", default="auto",
                    choices=["auto", "wls", "gls", "downhill", "wideband"])
    ap.add_argument("--full-cov", action="store_true",
                    help="dense covariance GLS path")
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--outfile", default=None,
                    help="write the fitted model to this par file")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plotfile", default=None)
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.fitting import (
        GLSFitter,
        WidebandTOAFitter,
        WLSFitter,
        auto_fitter,
    )
    from pint_tpu_torch.models.builder import get_model_and_toas

    model, toas = get_model_and_toas(args.parfile, args.timfile)
    log.info("loaded %d TOAs, model %s", len(toas), model.name)

    dev = args.device
    kw = {}
    if args.fitter == "wls":
        fitter = WLSFitter(toas, model, device=dev)
    elif args.fitter == "gls":
        fitter = GLSFitter(toas, model, full_cov=args.full_cov, device=dev)
    elif args.fitter == "wideband":
        fitter = WidebandTOAFitter(toas, model, full_cov=args.full_cov,
                                   device=dev)
    else:  # auto, downhill
        fitter = auto_fitter(toas, model, device=dev)
    if args.maxiter:
        kw["maxiter"] = args.maxiter
    r = fitter.resids
    pre_rms = (r.toa if hasattr(r, "toa") else r).rms_weighted()
    chi2 = fitter.fit_toas(**kw)
    log.info("chi2 = %.4f", chi2)
    print(f"Pre-fit weighted RMS:  {pre_rms * 1e6:.4f} us")
    fitter.print_summary()
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(model.as_parfile())
        log.info("wrote %s", args.outfile)
    if args.plot or args.plotfile:
        import matplotlib

        matplotlib.use("Agg" if args.plotfile else matplotlib.get_backend())
        import matplotlib.pyplot as plt

        r = fitter.resids
        rr = r.toa if hasattr(r, "toa") else r
        mjd = toas.mjd_float()
        err = np.asarray(toas.error_us)
        plt.errorbar(mjd, rr.time_resids * 1e6, yerr=err, fmt=".")
        plt.xlabel("MJD")
        plt.ylabel("residual (us)")
        plt.title(f"{model.name} post-fit")
        if args.plotfile:
            plt.savefig(args.plotfile)
        else:
            plt.show()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
