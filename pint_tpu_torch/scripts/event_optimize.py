"""event_optimize: MCMC fit of a timing model to photon phases.

Reference parity: src/pint/scripts/event_optimize.py: maximize the
unbinned template likelihood sum(log f(phi_i(x))) over the model's free
parameters with an ensemble sampler.  The per-photon phase kernel and
the template density are one vmap-safe function of the delta vector x
(:func:`build_lnpost`), vmapped over the walkers by
``sampler.run_ensemble``, so every step is one replay of a step program
on ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import pint_tpu_torch.logging as plog
from pint_tpu_torch.device import F64
from pint_tpu_torch.scripts import add_device_argument


def build_lnpost(cm, template, weights=None):
    """Photon-template log-posterior over parameter deltas x, a function
    of one (nfree,) f64 tensor on ``cm.device`` (vmap-safe)."""
    tpar = torch.as_tensor(template.get_parameters(), dtype=F64,
                           device=cm.device)
    w = (None if weights is None
         else torch.as_tensor(np.asarray(weights), dtype=F64,
                              device=cm.device))

    def lnpost(x):
        # the TZR-anchored absolute phase: the template was fit to
        # absolute phases, so the likelihood must score the same anchor
        # or AbsPhase models bias the walk by the TZR fraction
        phases = torch.remainder(cm.absolute_phase(x).frac, 1.0)
        f = template(phases, params=tpar)
        if w is None:
            return torch.sum(torch.log(torch.clamp(f, min=1e-300)))
        return torch.sum(torch.log(torch.clamp(w * f + (1.0 - w),
                                               min=1e-300)))

    return lnpost


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MCMC-fit a timing model to photon phases"
    )
    ap.add_argument("eventfile")
    ap.add_argument("parfile")
    ap.add_argument(
        "gaussianfile",
        help="template: a .gauss component file (itemplate "
        "convention), a binned .prof profile, or the plain "
        "'weight:width:loc' one-peak-per-line format",
    )
    ap.add_argument(
        "--fit-template", action="store_true",
        help="ML-refit the template to the starting phases (with "
        "Hessian errors) before sampling, and write it back out as "
        "<outfile>.gauss when it is a Gaussian template",
    )
    ap.add_argument("--mission", default="generic")
    ap.add_argument("--weightcol", default=None)
    ap.add_argument(
        "--energycol", default=None,
        help="photon-energy column (MeV; e.g. Fermi ENERGY): feeds "
        "energy-dependent template primitives during --fit-template",
    )
    ap.add_argument("--nwalkers", type=int, default=32)
    ap.add_argument("--nsteps", type=int, default=500)
    ap.add_argument("--burnin", type=float, default=0.25)
    ap.add_argument("--outfile", default="event_optimize_post.par")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-level", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    log = plog.setup(args.log_level)

    from pint_tpu_torch.event_toas import get_event_weights, load_event_TOAs
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.sampler import run_ensemble
    from pint_tpu_torch.templates import LCGaussian, read_template
    from pint_tpu_torch.toas.ingest import ingest_for_model

    model = get_model(args.parfile)
    toas = load_event_TOAs(
        args.eventfile, mission=args.mission, weightcol=args.weightcol,
        energycol=args.energycol,
    )
    ingest_for_model(toas, model)
    cm = model.compile(toas, device=args.device, subtract_mean=False)
    log.info(
        "loaded %d photons; free params %s", len(toas), cm.free_names
    )

    template, _errs = read_template(args.gaussianfile)
    weights = get_event_weights(toas)

    if args.fit_template:
        from pint_tpu_torch.event_toas import get_event_energies
        from pint_tpu_torch.templates import LCFitter, write_gauss

        phases = torch.remainder(cm.absolute_phase(cm.x0()).frac, 1.0)
        log10_ens = None
        if template.is_energy_dependent:
            en = get_event_energies(toas)
            if en is None:
                raise SystemExit(
                    "energy-dependent template needs --energycol"
                )
            log10_ens = np.log10(en / 1000.0)  # MeV -> log10(E/GeV)
        lcf = LCFitter(template, phases, weights=weights,
                       log10_ens=log10_ens)
        ll = lcf.fit()
        errs = lcf.errors()
        log.info("template refit: loglike %.2f", ll)
        if all(isinstance(p, LCGaussian) for p in template.primitives):
            write_gauss(template, args.outfile + ".gauss", errors=errs)
            log.info("wrote %s.gauss", args.outfile)

    lnpost = build_lnpost(cm, template, weights)
    # seed the walker ball at the scale where each parameter shifts the
    # mean photon phase by ~0.05 cycles; forward mode, as the
    # double-double cores have no reverse-mode rule (nfree is small)
    g = torch.func.jacfwd(
        lambda x: cm.absolute_phase(x).frac.mean())(cm.x0())
    scales = 0.05 / np.maximum(np.abs(g.cpu().numpy()), 1e-30)
    chain, lnp, acc = run_ensemble(
        lnpost, np.zeros(cm.nfree), nwalkers=args.nwalkers,
        nsteps=args.nsteps, seed=args.seed, init_scale=scales,
        device=cm.device, programs=cm.programs,
    )
    log.info("acceptance %.3f", acc)
    nburn = int(args.burnin * len(chain))
    flat = chain[nburn:].reshape(-1, cm.nfree)
    med = np.median(flat, axis=0)
    std = np.std(flat, axis=0)
    cm.commit(med, uncertainties=std)
    i, j = np.unravel_index(np.argmax(lnp), lnp.shape)
    print(f"max log-likelihood: {float(lnp[i, j]):.2f}  "
          f"acceptance {acc:.3f}")
    for n in cm.free_names:
        p = model.params[n]
        print(f"  {n:<10} {p._format_value()} +- {p.uncertainty:.3e}")
    with open(args.outfile, "w") as f:
        f.write(model.as_parfile())
    log.info("wrote %s", args.outfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
