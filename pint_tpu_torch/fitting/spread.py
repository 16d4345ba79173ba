"""How far the exact-f64 GLS step moves under changes that are rounding only.

Two devices that both compute the f64 step (``gls_step_woodbury``) do not
agree bit for bit: their sums run in other orders, and their
transcendental functions may round the last bit of a delay the other
way.  These yardsticks measure, on one device, how far each of those
alone moves the step, in units of each parameter's sigma:

- :func:`ordering_gaps`: the same TOAs in another order
  (``toas/bundle.py::take_rows``), which changes only the order of the
  step's sums;
- :func:`rounding_gaps`: each TOA's residual moved by one ulp of that
  TOA's total delay, with seeded random signs — the size of a
  last-bit difference in the delays.

``chip_smoke.py`` holds the card's step against the CPU's with them, and
``tests/test_torch_binary.py`` pins their sizes on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.base import design_with_offset, noffset
from pint_tpu_torch.fitting.gls import gls_step_woodbury
from pint_tpu_torch.toas.bundle import as_table, take_rows


def step_inputs(cm, x):
    """(r, M, Ndiag, T, phi) of the GLS step at x: residuals without mean
    subtraction, the design with its offset column, the white variances
    and the correlated-noise basis and weights."""
    T, phi = cm.noise_basis_or_empty(x)
    return (cm.time_residuals(x, subtract_mean=False),
            design_with_offset(cm, x), torch.square(cm.scaled_sigma(x)),
            T, phi)


def f64_step(cm, r_shift=None):
    """The f64 step from the reference values on the host:
    -> (dx, sigma, names), with sigma each column's sqrt of the covariance
    diagonal (x units) and names ``offset`` plus the free parameters.
    ``r_shift`` (n,) is added to the residuals first."""
    r, M, Nd, T, phi = step_inputs(cm, cm.x0())
    if r_shift is not None:
        r = r + r_shift.to(r.device)
    dx, (covn, norm), _, _ = gls_step_woodbury(r, M, Nd, T, phi,
                                               normalized_cov=True)
    sig = torch.sqrt(torch.diagonal(covn)) / norm
    names = ["offset"] * noffset(cm) + list(cm.free_names)
    return dx.cpu(), sig.cpu(), names


def ordering_gaps(model, table, device, seeds=range(8)):
    """The largest |dx_perm - dx| / sigma over the parameters, for each of
    ``len(seeds)`` seeded permutations of the table's TOAs.  On the
    binary MSP's in-phase copy one permutation's gap falls anywhere from
    1e-13 to 5e-12 sigma, so a yardstick takes the largest of eight."""
    table = as_table(table)
    dx, sig, _ = f64_step(model.compile(table, device=device))
    n = len(table["freq_mhz"])
    out = []
    for s in seeds:
        perm = np.random.default_rng(s).permutation(n)
        dxp, _, _ = f64_step(model.compile(take_rows(table, perm),
                                           device=device))
        out.append(float(torch.max(torch.abs(dxp - dx) / sig)))
    return out


def rounding_gaps(model, table, device, seeds=(0, 1, 2)):
    """The largest |dx_shifted - dx| / sigma over the parameters, for each
    of ``len(seeds)`` seeded shifts of every TOA's residual by one ulp of
    its total delay (random signs)."""
    cm = model.compile(table, device=device)
    dx, sig, _ = f64_step(cm)
    delay = cm.delay(cm.x0()).cpu().numpy()
    ulp = torch.as_tensor(np.spacing(np.abs(delay)))
    out = []
    for s in seeds:
        sign = np.random.default_rng(s).choice([-1.0, 1.0], size=len(delay))
        dxs, _, _ = f64_step(cm, r_shift=torch.as_tensor(sign) * ulp)
        out.append(float(torch.max(torch.abs(dxs - dx) / sig)))
    return out
