"""Spindown: rotational phase as a Taylor series in F0..Fn.

Counterpart of ``pint_tpu/models/spindown.py``: phase =
taylor_horner(dt, [0, F0, F1, ...]) with dt = TDB - PEPOCH - delay in DD
seconds; F0 is a DD parameter (an f64 F0 alone would alias ~100 ns of
phase over 20 yr).
"""

from __future__ import annotations

from pint_tpu_torch.models.component import PhaseComponent
from pint_tpu_torch.models.parameter import MJDParameter, floatParameter
from pint_tpu_torch.ops.taylor import taylor_horner_dd, taylor_horner_deriv_dd


class Spindown(PhaseComponent):
    category = "spindown"

    def __init__(self, max_fterms: int = 12):
        super().__init__()
        self.add_param(
            floatParameter("F0", units="Hz", long_double=True, frozen=False)
        )
        self.add_param(floatParameter("F1", units="Hz/s"))
        for k in range(2, max_fterms + 1):
            self.add_param(floatParameter(f"F{k}", units=f"Hz/s^{k}"))
        self.add_param(MJDParameter("PEPOCH"))

    def validate(self, model):
        self.require("F0")
        set_ks = sorted(
            int(n[1:]) for n in self.params
            if n.startswith("F") and n[1:].isdigit()
            and self.params[n].value is not None
        )
        if set_ks != list(range(0, set_ks[-1] + 1)):
            raise ValueError(f"non-contiguous spin terms F{set_ks}")
        if len(set_ks) > 1 and self.params["PEPOCH"].value is None:
            raise ValueError("PEPOCH required when F1.. are set")

    def _coeff_names(self):
        """Contiguous F-terms F0..Fn actually set."""
        names = []
        k = 0
        while f"F{k}" in self.params and self.params[f"F{k}"].value is not None:
            names.append(f"F{k}")
            k += 1
        return names

    def _dt(self, pdict, bundle, delay):
        if self.params["PEPOCH"].value is not None:
            day, sec = pdict["PEPOCH"]
        else:
            day, sec = float(bundle.tdb_day[0]), 0.0
        return bundle.dt_seconds(day, sec) - delay

    def phase_term(self, pdict, bundle, delay):
        dt = self._dt(pdict, bundle, delay)
        coeffs = [0.0] + [pdict[n] for n in self._coeff_names()]
        return taylor_horner_dd(dt, coeffs)

    def spin_frequency(self, pdict, bundle):
        """f(t) at each TOA (no delay correction, as the reference)."""
        dt = self._dt(pdict, bundle, 0.0)
        coeffs = [0.0] + [pdict[n] for n in self._coeff_names()]
        return taylor_horner_deriv_dd(dt, coeffs, 1).to_float()
