"""fermiphase: Fermi-LAT photon phase assignment.

Reference parity: src/pint/scripts/fermiphase.py: the Fermi front end of
the photonphase machinery (mission defaults, a weight column for the
H-test); the phases are ``CompiledModel.absolute_phase`` on ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compute phases for Fermi-LAT photons"
    )
    ap.add_argument("eventfile")
    ap.add_argument("parfile")
    ap.add_argument("--weightcol", default=None,
                    help="photon-weight column name (e.g. MODEL_WEIGHT)")
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--plotfile", default=None)
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.event_toas import get_event_weights, load_event_TOAs
    from pint_tpu_torch.eventstats import h2sig, hm
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toas.ingest import ingest_for_model

    model = get_model(args.parfile)
    # the weights ride in the TOA flags, so they survive the time sort
    toas = load_event_TOAs(
        args.eventfile, mission="fermi", weightcol=args.weightcol
    )
    weights = get_event_weights(toas)
    log.info("loaded %d Fermi photons", len(toas))
    ingest_for_model(toas, model)
    cm = model.compile(toas, device=args.device, subtract_mean=False)
    phases = np.mod(cm.absolute_phase(cm.x0()).frac.cpu().numpy(), 1.0)
    h = hm(phases, weights=weights, device=cm.device)
    print(f"Htest : {h:.2f}  ({h2sig(h):.2f} sigma)")
    if args.outfile:
        from pint_tpu_torch.io.fits import add_column

        add_column(args.eventfile, args.outfile, "PULSE_PHASE", phases)
        log.info("wrote %s", args.outfile)
    if args.plotfile:
        from pint_tpu_torch.plot_utils import phaseogram

        phaseogram(
            toas.mjd_float(), phases, weights=weights,
            plotfile=args.plotfile,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
