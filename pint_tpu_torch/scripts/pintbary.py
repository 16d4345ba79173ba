"""pintbary: quick barycentring of times.

Reference parity: src/pint/scripts/pintbary.py: topocentric UTC MJDs to
barycentric arrival times (TDB at the SSB) for a sky position; the
delays are evaluated on ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description="Barycenter times (pintbary)")
    ap.add_argument("mjds", nargs="+", type=float, help="UTC MJD(s)")
    ap.add_argument("--obs", default="geocenter")
    ap.add_argument("--ra", required=True, help="RAJ (hh:mm:ss.s)")
    ap.add_argument("--dec", required=True, help="DECJ (dd:mm:ss.s)")
    ap.add_argument("--ephem", default="builtin")
    ap.add_argument("--freq", type=float, default=np.inf)
    ap.add_argument("--dm", type=float, default=0.0)
    ap.add_argument("--log-level", default="WARNING")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    plog.setup(args.log_level)

    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.timebase.times import TimeArray
    from pint_tpu_torch.toas.ingest import ingest
    from pint_tpu_torch.toas.toas import TOAs

    par = (
        f"PSR BARY\nRAJ {args.ra}\nDECJ {args.dec}\nF0 1.0\n"
        f"PEPOCH {args.mjds[0]}\nDM {args.dm}\n"
    )
    model = get_model(par)
    n = len(args.mjds)
    toas = TOAs(
        TimeArray.from_mjd_float(np.asarray(args.mjds), scale="utc"),
        np.full(n, args.freq), np.ones(n), [args.obs] * n,
        [dict() for _ in range(n)],
    )
    ingest(toas, ephem=args.ephem, model=model)
    cm = model.compile(toas, device=args.device)
    delay = cm.delay(cm.x0()).cpu().numpy()
    t_bary = toas.t_tdb.add_seconds(-delay)
    for s in t_bary.to_mjd_strings(15):
        print(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
