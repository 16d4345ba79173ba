"""Chromatic (f^-CMIDX) delay: the ChromaticCM Taylor model.

Counterpart of ``pint_tpu/models/chromatic.py::ChromaticCM``: delay =
DM_CONST CM(t) / f^CMIDX with f in MHz and CM in pc cm^-3 MHz^(CMIDX-2),
CM(t) a Taylor series in (t - CMEPOCH).  CMIDX (par alias TNCHROMIDX) is
also the index PLChromNoise and CMWaveX read; 4 models scattering.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import DM_CONST, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.exceptions import MissingParameter, TimingModelError
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    prefix_index,
)
from pint_tpu_torch.ops.taylor import taylor_horner


def _cm_deriv(k: int) -> floatParameter:
    return floatParameter(f"CM{k}", units=f"pc/cm^3 MHz^(a-2)/yr^{k}",
                          scale_to_internal=SECS_PER_JULIAN_YEAR ** (-k))


class ChromaticCM(DelayComponent):
    register = True
    category = "chromatic"
    prefix_patterns = ("CM",)

    def __init__(self, max_terms: int = 6):
        super().__init__()
        self.add_param(floatParameter("CM", units="pc/cm^3 MHz^(a-2)"))
        self.add_param(floatParameter("CMIDX", value=4.0,
                                      aliases=("TNCHROMIDX", "TNChromIdx")))
        for k in range(1, max_terms + 1):
            self.add_param(_cm_deriv(k))
        self.add_param(MJDParameter("CMEPOCH"))

    def new_prefix_param(self, name):
        k = prefix_index(name, "CM")
        if k is None or k < 1:
            return None
        if f"CM{k}" not in self.params:
            self.add_param(_cm_deriv(k))
        return self.params[f"CM{k}"]

    def _deriv_ks(self):
        return sorted(int(n[2:]) for n in self.params
                      if n.startswith("CM") and n[2:].isdigit()
                      and self.params[n].value is not None)

    def validate(self, model):
        ks = self._deriv_ks()
        if ks:
            if ks != list(range(1, ks[-1] + 1)):
                raise TimingModelError(f"non-contiguous chromatic "
                                       f"derivatives CM{ks}")
            if self.params["CMEPOCH"].value is None:
                raise MissingParameter("ChromaticCM", "CMEPOCH")

    def cm_value(self, pdict, bundle):
        coeffs = [pdict["CM"]] + [pdict[f"CM{k}"] for k in self._deriv_ks()]
        if len(coeffs) == 1:
            return coeffs[0] * torch.ones_like(bundle.freq_mhz)
        day, sec = pdict["CMEPOCH"]
        dt = bundle.dt_seconds(day, sec).to_float()
        return taylor_horner(dt, coeffs)

    def delay_term(self, pdict, bundle, acc_delay):
        if self.params["CM"].value is None:
            return torch.zeros_like(bundle.freq_mhz)
        alpha = pdict.get("CMIDX", 4.0)
        return DM_CONST * self.cm_value(pdict, bundle) / (
            bundle.freq_mhz ** alpha)
