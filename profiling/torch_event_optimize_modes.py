"""event_optimize's F0 log-likelihood landscape, and its stretch walk on a
device against the CPU from the same walkers and draws.

    python3 profiling/torch_event_optimize_modes.py [--device cuda]
        [--span 3000] [--photons 100000] [--steps 200]

The photons are ``chip_smoke.py``'s phase-15 photons (1e5, each pulsed
with its weight as probability from a two-Gaussian template) over
``--span`` seconds, and the model starts F0 1e-4 Hz off the truth, as
phase 15 does.  Prints the local maxima of the log-posterior
(``scripts/event_optimize.py::build_lnpost``) over F0 from truth - 5e-4
to truth + 5e-4 Hz on the CPU; with ``--device`` other than cpu also
the same function there (vmapped) against the CPU, and ``--steps``
steps of ``sampler.run_ensemble`` from the same walkers and the same
draws on both (the chains' largest gap; the device's through its step
program).  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pint_tpu_torch.event_toas import (  # noqa: E402
    get_event_weights,
    load_event_TOAs,
)
from pint_tpu_torch.io.fits import write_event_fits  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.sampler import (  # noqa: E402
    ensemble_init,
    ensemble_keys,
    run_ensemble,
    stretch_draws,
)
from pint_tpu_torch.scripts.event_optimize import build_lnpost  # noqa: E402
from pint_tpu_torch.templates import (  # noqa: E402
    LCGaussian,
    LCTemplate,
    read_template,
)
from pint_tpu_torch.toas.ingest import ingest_barycentric  # noqa: E402


def photons(tmp: Path, n: int, span: float):
    """Phase 15's event file and template file (chip_smoke.py's
    ``optimize_tool``, its model phases on the CPU)."""
    truth = LCTemplate([LCGaussian(width=0.03, loc=0.3),
                        LCGaussian(width=0.08, loc=0.7)], weights=[0.35, 0.25])
    rng = np.random.default_rng(16)
    met = rng.uniform(0.0, span, n)
    w = rng.uniform(0.0, 1.0, n)
    hdr = {"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0,
           "TIMESYS": "TDB"}
    ev = tmp / "ev.fits"
    write_event_fits(str(ev), {"TIME": met}, header_extra=hdr)
    toas = load_event_TOAs(str(ev))
    ingest_barycentric(toas)
    order = np.argsort(met, kind="stable")
    met, w = met[order], w[order]
    cm = get_model(cs.OPT_PAR).compile(toas, device="cpu",
                                       subtract_mean=False)
    model_ph = cm.phase(cm.x0()).frac.numpy()
    pulsed = rng.uniform(size=n) < w
    want = rng.uniform(size=n)
    want[pulsed] = truth.random(int(pulsed.sum()), rng=rng, device="cpu")
    met = met + (np.mod(want - model_ph + 0.5, 1.0) - 0.5) / cs.OPT_F0
    order = np.argsort(met, kind="stable")
    write_event_fits(str(ev), {"TIME": met[order], "WEIGHT": w[order]},
                     header_extra=hdr)
    gauss = tmp / "t.gauss"
    fwhm = 2.0 * math.sqrt(2.0 * math.log(2.0))
    gauss.write_text(
        f"const = 0.4\nphas1 = 0.3\nfwhm1 = {0.03 * fwhm!r}\nampl1 = 0.35\n"
        f"phas2 = 0.7\nfwhm2 = {0.08 * fwhm!r}\nampl2 = 0.25\n")
    return ev, gauss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--span", type=float, default=3000.0)
    ap.add_argument("--photons", type=int, default=cs.OPT_PHOTONS)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    tmp = Path(tempfile.mkdtemp())
    ev, gauss = photons(tmp, args.photons, args.span)
    tmpl, _ = read_template(str(gauss))
    toas = load_event_TOAs(str(ev), weightcol="WEIGHT")
    ingest_barycentric(toas)
    wts = get_event_weights(toas)
    devs = ["cpu"] + ([args.device] if args.device != "cpu" else [])
    cms = {d: get_model(cs.OPT_START_PAR).compile(toas, device=d,
                                                  subtract_mean=False)
           for d in devs}
    lps = {d: build_lnpost(cm, tmpl, wts) for d, cm in cms.items()}
    start_off = float(cms["cpu"].model.params["F0"].value.to_float()
                      - cs.OPT_F0)
    dx = np.linspace(-5e-4, 5e-4, 401) - start_off  # about the truth
    x = torch.as_tensor(dx[:, None])
    lnp = torch.func.vmap(lps["cpu"])(x).numpy()
    print(f"photons {args.photons} over {args.span} s, F0 started "
          f"{start_off:+.3e} Hz off the truth")
    for i in range(1, len(lnp) - 1):
        if lnp[i] >= lnp[i - 1] and lnp[i] >= lnp[i + 1]:
            print(f"  local maximum at truth {dx[i] + start_off:+.3e} Hz: "
                  f"log-posterior {lnp[i]:.2f}")
    if len(devs) == 1:
        return 0
    dev = devs[1]
    lnp_dev = torch.func.vmap(lps[dev])(x.to(dev)).cpu().numpy()
    print(f"{dev} vs cpu, log-posterior: largest gap "
          f"{np.max(np.abs(lnp_dev - lnp))!r}")
    walkers, key = ensemble_init(np.zeros(1), nwalkers=cs.OPT_WALKERS,
                                 seed=1, init_scale=np.array([3.3e-5]),
                                 device="cpu")
    seeds = ensemble_keys(key, args.steps)
    gen = torch.Generator(device="cpu")
    half = cs.OPT_WALKERS // 2
    draws = [tuple(t.numpy() for t in stretch_draws(
        seeds[i], half, torch.device("cpu"), gen)) for i in range(args.steps)]
    chains = {}
    for d in devs:
        t0 = time.perf_counter()
        chain, _, acc = run_ensemble(
            lps[d], np.zeros(1), nwalkers=cs.OPT_WALKERS, nsteps=args.steps,
            init_walkers=walkers.numpy(), device=d, programs=cms[d].programs,
            draws=draws)
        chains[d] = chain
        print(f"{d}: acceptance {acc:.4f}, median of the last half "
              f"{np.median(chain[args.steps // 2:]) + start_off:+.3e} Hz "
              f"off the truth, {time.perf_counter() - t0:.2f} s, "
              f"{cms[d].programs.replays} replays")
    print(f"chains {dev} vs cpu: largest gap "
          f"{np.max(np.abs(chains[dev] - chains['cpu']))!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
