"""Template file IO: .gauss component files and .prof binned profiles.

Counterpart of ``pint_tpu/templates/lcio.py``, a copy of its host
parsers (reference parity: src/pint/templates/lctemplate.py prim_io /
gauss_template round-trip, and the scripts/event_optimize.py template
loading path): the two on-disk template formats the photon pipeline
exchanges with tempo/itemplate tooling:

.gauss — itemplate/pointlike Gaussian-component text:

    # comments
    const = 0.400 +/- 0.0100
    phas1 = 0.1000 +/- 0.0010
    fwhm1 = 0.0400 +/- 0.0020
    ampl1 = 0.3500 +/- 0.0100
    phas2 = ...

  const is the unpulsed fraction (1 - sum of ampl); fwhm is in cycles
  (width sigma = fwhm / (2 sqrt(2 ln 2))).  Errors are optional on
  read and written when the template carries them.

.prof — a binned intensity profile: one value per line (or two
  columns, bin index + value); becomes an LCBinnedProfile primitive
  with weight 1 - const (const estimated from the profile minimum).
"""

from __future__ import annotations

import math
import re

import numpy as np

from pint_tpu_torch.templates.lcprimitives import LCBinnedProfile, LCGaussian
from pint_tpu_torch.templates.lctemplate import LCTemplate

_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))
_LINE = re.compile(
    r"^\s*(const|phas|fwhm|ampl)\s*(\d*)\s*=\s*([-+0-9.eE]+)"
    r"(?:\s*\+/-\s*([-+0-9.eE]+))?"
)


def read_gauss(path):
    """-> (LCTemplate of LCGaussians, errors vector in
    get_parameters() layout or None)."""
    fields: dict[tuple[str, int], tuple[float, float | None]] = {}
    for line in open(path):
        m = _LINE.match(line)
        if not m:
            continue
        key, idx, val, err = m.groups()
        fields[(key, int(idx or 0))] = (
            float(val), None if err is None else float(err)
        )
    ncomp = max((i for (k, i) in fields if k == "ampl"), default=0)
    if ncomp == 0:
        raise ValueError(f"{path}: no ampl# components found")
    prims, weights = [], []
    for i in range(1, ncomp + 1):
        try:
            phas = fields[("phas", i)]
            fwhm = fields[("fwhm", i)]
            ampl = fields[("ampl", i)]
        except KeyError as e:
            raise ValueError(
                f"{path}: incomplete component {i} ({e})"
            ) from None
        prims.append(LCGaussian(width=fwhm[0] / _FWHM, loc=phas[0]))
        weights.append(ampl[0])
    tmpl = LCTemplate(prims, weights=weights)
    # errors, if every field carried one
    errs = []
    have_all = all(v[1] is not None for v in fields.values())
    if have_all:
        errs = [fields[("ampl", i)][1] for i in range(1, ncomp + 1)]
        for i in range(1, ncomp + 1):
            errs.append(fields[("fwhm", i)][1] / _FWHM)
            errs.append(fields[("phas", i)][1])
    return tmpl, (np.asarray(errs) if have_all else None)


def write_gauss(template: LCTemplate, path, errors=None):
    """Write an all-Gaussian template (+ optional errors in
    get_parameters() layout)."""
    n = len(template.primitives)
    if not all(isinstance(p, LCGaussian) for p in template.primitives):
        raise ValueError(".gauss files hold LCGaussian components only")

    def fmt(val, err):
        # %.8f for values: a high-statistics phase fit localizes to
        # few-1e-7, finer than %.6f quantization; %g for the error
        # (%.6f would floor a few-1e-7 error to a claimed-exact 0)
        if err is None:
            return f"{val:.8f}"
        return f"{val:.8f} +/- {err:.4g}"

    e = None if errors is None else np.asarray(errors)
    lines = ["# pint_tpu template (itemplate .gauss convention)"]
    const = 1.0 - float(np.sum(template.weights))
    lines.append(f"const = {fmt(const, None if e is None else 0.0)}")
    for i, (w, p) in enumerate(
        zip(template.weights, template.primitives), start=1
    ):
        we = None if e is None else e[i - 1]
        k = n + 2 * (i - 1)
        fe = None if e is None else e[k] * _FWHM
        pe = None if e is None else e[k + 1]
        lines.append(f"phas{i} = {fmt(p.params[1] % 1.0, pe)}")
        lines.append(f"fwhm{i} = {fmt(p.params[0] * _FWHM, fe)}")
        lines.append(f"ampl{i} = {fmt(float(w), we)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_prof(path):
    """Binned profile -> LCTemplate([LCBinnedProfile], [1 - const]);
    const (unpulsed fraction) is estimated from the profile minimum.
    Baseline-subtracted profiles (values straddling zero) are handled
    by splitting on the SHIFTED profile: the pulsed fraction is
    pulsed_sum / (pulsed_sum + nbins * baseline-above-zero), never a
    negative or blown-up weight."""
    raw = np.loadtxt(path)
    vals = raw[:, -1] if raw.ndim == 2 else raw
    base = float(vals.min())
    pulsed = vals - base
    ps = float(pulsed.sum())
    if ps <= 0:
        raise ValueError(f"{path}: profile is constant (no pulse)")
    w = ps / (ps + len(vals) * max(base, 0.0))
    return LCTemplate([LCBinnedProfile(pulsed + 1e-12)], weights=[w])


def write_prof(template: LCTemplate, path, nbins: int = 256):
    """Sample any template onto nbins (on the host) and write one value
    per line."""
    phases = (np.arange(nbins) + 0.5) / nbins
    vals = np.asarray(template(phases))
    np.savetxt(path, vals, fmt="%.8f")
    return path


def read_template(path):
    """The one template-format dispatch (used by event_optimize):
    .gauss -> component template; the legacy one-peak-per-line
    'weight:width:loc' text -> Gaussian template; anything else ->
    binned .prof profile.  Returns (template, errors-or-None)."""
    path = str(path)
    first = ""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                first = line
                break
    # content sniffing, not extension: 'const = ...' lines mean the
    # itemplate convention whatever the file is called
    if path.endswith(".gauss") or "=" in first:
        return read_gauss(path)
    if ":" in first:
        prims, wts = [], []
        for line in open(path):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            wt, width, loc = (float(v) for v in line.split(":"))
            prims.append(LCGaussian(width=width, loc=loc))
            wts.append(wt)
        return LCTemplate(prims, weights=wts), None
    return read_prof(path), None
