"""Where the card's exact-f64 GLS step parts from the CPU's, stage by stage.

    python3 profiling/torch_r4_stages.py [ntoa] [ndmx]

On the binary MSP's small copy simulated with the orbit inside its
phases (``chip_smoke.py``'s ``sigma_gap`` copy: ``msp_par(ndmx)``, default
2048 TOAs and 12 DMX ranges), computes every stage of ``gls_step_woodbury``
on the card and on the CPU from the same host table and prints how far
apart they are: each delay component's term and the residuals in ulps of
their largest magnitude, the design matrix column by column, N^-1, T,
phi, Sigma, C^-1 Mn, A, b and the solved dx.  Then it swaps one stage at
a time — the CPU step from the card's residuals, from the card's design
matrix, from the card's noise terms, and the CPU's solve of the card's
(A, b) — and prints each swap's gap from the CPU step in units of each
parameter's sigma, beside the card's whole gap and the CPU's yardsticks
(``fitting/spread.py``: TOAs reordered; residuals moved by one ulp of
their delay), the ecliptic astrometry's parts in ulps (the angles; their
sines and cosines taken directly and about the reference angles, as the
component takes them; the unit vector; r.n), and the condition number
of the normalized normal matrix A.  Prints one JSON line, then the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pint_tpu_torch.fitting.gls import (  # noqa: E402
    _column_norms,
    _eigh_threshold_solve,
    gls_step_woodbury,
    make_cinv_mult,
    woodbury_sigma,
)
from pint_tpu_torch.fitting.spread import (  # noqa: E402
    f64_step,
    ordering_gaps,
    rounding_gaps,
    step_inputs,
)
from pint_tpu_torch.models.astrometry import sincos_about  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
)

SIM = dict(start_mjd=53000.0, end_mjd=57500.0, seed=0, iterations=1,
           orbit=True, freqs=MSP_FREQS, orbit_in_phase=True)


def stages(model, table, device):
    """Every stage of the f64 step from the reference values, on the host."""
    cm = model.compile(table, device=device)
    x = cm.x0()
    pd = cm._pdict(x)
    out = {}
    acc = torch.zeros(cm.bundle.ntoa, dtype=torch.float64, device=cm.device)
    for c in model.delay_components:
        term = c.delay_term(pd, cm.bundle, acc)
        acc = acc + term
        out[f"delay:{type(c).__name__}"] = term
    out["delay"] = acc
    r, M, Nd, T, phi = step_inputs(cm, x)
    norm = _column_norms(M)
    Mn = M / norm[None, :]
    cinv = make_cinv_mult(Nd, T, phi)
    Ninv, _, Sigma = woodbury_sigma(Nd, T, phi)
    CiMn = cinv(Mn)
    Cir = cinv(r[:, None])[:, 0]
    A = Mn.T @ CiMn
    b = -(Mn.T @ Cir)
    dxn, _, _ = _eigh_threshold_solve(A, b)
    out.update(r=r, M=M, Nd=Nd, T=T, phi=phi, Ninv=Ninv, Sigma=Sigma,
               CiMn=CiMn, A=A, b=b, dxn=dxn, norm=norm)
    return {k: v.detach().cpu() for k, v in out.items()}


def astrometry_parts(model, table, device):
    """The ecliptic astrometry delay's parts (AstrometryEcliptic), on
    the host: the per-TOA angles, their sines and cosines (directly, and
    about the reference angles), the unit vector, r.n by torch.sum and by
    three products added in order."""
    cm = model.compile(table, device=device)
    pd = cm._pdict(cm.x0())
    c = model.components["AstrometryEcliptic"]
    b = cm.bundle
    dt = c._dt_pos(pd, b)
    bet = pd["ELAT"] + pd["PMELAT"] * dt
    lam = pd["ELONG"] + pd["PMELONG"] * dt / torch.cos(pd["ELAT"])
    n = c.ssb_to_psr_xyz(pd, b)
    r = b.ssb_obs_pos_ls
    sl, cl = sincos_about(lam, c.params["ELONG"].internal())
    sb, cb = sincos_about(bet, c.params["ELAT"].internal())
    out = dict(lam=lam, bet=bet, sin_lam=torch.sin(lam),
               cos_lam=torch.cos(lam), sin_bet=torch.sin(bet),
               cos_bet=torch.cos(bet), sin_lam_about=sl, cos_lam_about=cl,
               sin_bet_about=sb, cos_bet_about=cb, n=n,
               rn_sum=torch.sum(r * n, dim=-1),
               rn_ordered=(r[:, 0] * n[:, 0] + r[:, 1] * n[:, 1])
               + r[:, 2] * n[:, 2])
    return {k: v.detach().cpu() for k, v in out.items()}


def ulp_diff(a, b):
    """Largest |a - b| in ulps of b's elements."""
    sp = torch.as_tensor(np.spacing(np.abs(b.numpy())))
    return float(torch.max(torch.abs(a - b) / torch.clamp(sp, min=1e-300)))


def sigma_gap(dx, ref_dx, sig, names):
    gap = torch.abs(dx - ref_dx) / sig
    i = int(torch.argmax(gap))
    return dict(max=float(gap[i]), worst=names[i])


def main():
    if not torch.cuda.is_available():
        print("torch_r4_stages: no CUDA device", file=sys.stderr)
        return 2
    ntoa = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    ndmx = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    model, table = make_test_pulsar(msp_par(ndmx, seed=0), ntoa=ntoa,
                                    device="cpu", **SIM)
    card, host = stages(model, table, "cuda"), stages(model, table, "cpu")
    diffs = {}
    for k, h in host.items():
        d = torch.abs(card[k] - h)
        scale = float(torch.max(torch.abs(h)))
        entry = dict(max_abs=float(torch.max(d)), rel=float(torch.max(d))
                     / (scale or 1.0))
        if k.startswith("delay") or k == "r":
            # in ulps of the largest magnitude of the term
            entry["ulps"] = (float(torch.max(d))
                             / float(np.spacing(scale or 1.0)))
        if k == "M":
            colmax = torch.clamp(torch.max(torch.abs(h), dim=0).values,
                                 min=1e-300)
            entry["worst_col_rel"] = float(torch.max(
                torch.max(d, dim=0).values / colmax))
        diffs[k] = entry
    cm = model.compile(table, device="cpu")
    dx_h, sig, names = f64_step(cm)
    dx_c, _, _ = f64_step(model.compile(table, device="cuda"))
    r, M, Nd, T, phi = step_inputs(cm, cm.x0())
    swaps = {}

    def swapped(r_, M_, Nd_, T_, phi_):
        dx, _, _, _ = gls_step_woodbury(r_, M_, Nd_, T_, phi_,
                                        normalized_cov=True)
        return sigma_gap(dx, dx_h, sig, names)

    swaps["card_r"] = swapped(card["r"], M, Nd, T, phi)
    swaps["card_M"] = swapped(r, card["M"], Nd, T, phi)
    swaps["card_noise"] = swapped(r, M, card["Nd"], card["T"], card["phi"])
    dxn, _, _ = _eigh_threshold_solve(card["A"], card["b"])
    swaps["card_A_b_cpu_solve"] = sigma_gap(dxn / host["norm"], dx_h, sig,
                                            names)
    whole = sigma_gap(dx_c, dx_h, sig, names)
    yard = dict(ordering=ordering_gaps(model, table, "cpu"),
                rounding=rounding_gaps(model, table, "cpu"))
    pc = astrometry_parts(model, table, "cuda")
    ph = astrometry_parts(model, table, "cpu")
    astro = {k: ulp_diff(pc[k], ph[k]) for k in ph}
    ev = torch.linalg.eigvalsh(host["A"])
    print(json.dumps(dict(ntoa=ntoa, ndmx=ndmx, stages=diffs, swaps=swaps,
                          card_gap=whole, cpu_yardsticks=yard,
                          astrometry_ulps=astro,
                          cond_A=float(ev[-1] / ev[0]))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
