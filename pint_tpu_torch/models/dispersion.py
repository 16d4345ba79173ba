"""Dispersion delay: the DM polynomial.

Counterpart of ``pint_tpu/models/dispersion.py::DispersionDM``: delay =
K * DM(t) / f^2 with K the Tempo constant, DM(t) a Taylor series in
(t - DMEPOCH) with the factorial convention.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import DM_CONST, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import MJDParameter, floatParameter
from pint_tpu_torch.ops.taylor import taylor_horner


class DispersionDM(DelayComponent):
    category = "dispersion_constant"
    triggers = ("DM", "DMEPOCH") + tuple(f"DM{k}" for k in range(1, 11))

    def __init__(self, max_terms: int = 10):
        super().__init__()
        self.add_param(floatParameter("DM", units="pc/cm^3", frozen=False))
        for k in range(1, max_terms + 1):
            # DMk in pc cm^-3 / yr^k -> internal per-second^k
            self.add_param(
                floatParameter(
                    f"DM{k}", units=f"pc/cm^3/yr^{k}",
                    scale_to_internal=SECS_PER_JULIAN_YEAR ** (-k),
                )
            )
        self.add_param(MJDParameter("DMEPOCH"))

    def validate(self, model):
        if (
            self.params["DM1"].value is not None
            and self.params["DMEPOCH"].value is None
        ):
            raise ValueError("DMEPOCH required when DM1 is set")

    def _coeffs(self, pdict):
        out = [pdict["DM"]]
        k = 1
        while f"DM{k}" in pdict and self.params[f"DM{k}"].value is not None:
            out.append(pdict[f"DM{k}"])
            k += 1
        return out

    def dm_value(self, pdict, bundle):
        """DM at each TOA (pc/cm^3)."""
        coeffs = self._coeffs(pdict)
        if len(coeffs) == 1:
            return coeffs[0] * torch.ones_like(bundle.freq_mhz)
        day, sec = pdict["DMEPOCH"]
        dt = bundle.dt_seconds(day, sec).to_float()
        return taylor_horner(dt, coeffs)

    def delay_term(self, pdict, bundle, acc_delay):
        dm = self.dm_value(pdict, bundle)
        return DM_CONST * dm / torch.square(bundle.freq_mhz)
