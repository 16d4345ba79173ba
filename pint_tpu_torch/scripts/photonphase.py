"""photonphase: assign model phases to photon events.

Reference parity: src/pint/scripts/photonphase.py: load an event FITS
file, compute each photon's TZR-anchored absolute pulse phase
(``CompiledModel.absolute_phase`` on ``--device``), run the H-test,
optionally write a PULSE_PHASE column.
"""

from __future__ import annotations

import argparse

import numpy as np

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Assign pulse phases to photon events"
    )
    ap.add_argument("eventfile")
    ap.add_argument("parfile")
    ap.add_argument("--mission", default="generic")
    ap.add_argument("--outfile", default=None,
                    help="write events + PULSE_PHASE to this FITS file")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plotfile", default=None)
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.eventstats import h2sig, hm
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toas.ingest import ingest_for_model

    model = get_model(args.parfile)
    toas = load_event_TOAs(args.eventfile, mission=args.mission)
    log.info("loaded %d photons", len(toas))
    ingest_for_model(toas, model)
    cm = model.compile(toas, device=args.device, subtract_mean=False)
    # the TZR-anchored absolute phase (reference: photonphase's
    # model.phase(abs_phase=True)), so PULSE_PHASE has the TZR zero
    ph = cm.absolute_phase(cm.x0())
    phases = np.mod(ph.frac.cpu().numpy(), 1.0)
    h = hm(phases, device=cm.device)
    print(f"Htest : {h:.2f}  ({h2sig(h):.2f} sigma)")
    if args.outfile:
        from pint_tpu_torch.io.fits import add_column

        add_column(args.eventfile, args.outfile, "PULSE_PHASE", phases)
        log.info("wrote %s", args.outfile)
    if args.plotfile or args.plot:
        import matplotlib

        matplotlib.use("Agg" if args.plotfile else matplotlib.get_backend())
        import matplotlib.pyplot as plt

        plt.hist(phases, bins=32)
        plt.xlabel("pulse phase")
        plt.ylabel("photons")
        if args.plotfile:
            plt.savefig(args.plotfile)
        else:
            plt.show()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
