"""zima: simulate fake TOAs from a timing model.

Reference parity: src/pint/scripts/zima.py (wraps simulation.py); the
model's residual sweeps of the simulation run on ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np

import pint_tpu_torch.logging as plog
from pint_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description="Simulate TOAs (zima)")
    ap.add_argument("parfile")
    ap.add_argument("timfile", help="output tim file")
    ap.add_argument("--ntoa", type=int, default=100)
    ap.add_argument("--startMJD", type=float, default=56000.0)
    ap.add_argument("--duration", type=float, default=400.0, help="days")
    ap.add_argument("--error", type=float, default=1.0, help="TOA sigma, us")
    ap.add_argument("--freq", type=float, nargs="+", default=[1400.0],
                    help="observing frequencies (MHz), cycled over TOAs")
    ap.add_argument("--obs", default="@")
    ap.add_argument("--addnoise", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.io.tim import write_tim_file
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    model = get_model(args.parfile)
    freqs = np.resize(np.asarray(args.freq, dtype=np.float64), args.ntoa)
    rng = (
        np.random.default_rng(args.seed) if args.seed is not None else None
    )
    toas = make_fake_toas_uniform(
        args.startMJD, args.startMJD + args.duration, args.ntoa, model,
        error_us=args.error, freq_mhz=freqs, obs=args.obs,
        add_noise=args.addnoise, rng=rng, device=args.device,
    )
    write_tim_file(args.timfile, toas)
    log.info("wrote %d TOAs to %s", len(toas), args.timfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
