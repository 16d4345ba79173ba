"""Explicit overall phase offset.

Counterpart of ``pint_tpu/models/phase_offset.py::PhaseOffset``: PHOFF in
pulse cycles, subtracted from the model phase of every row of a bundle;
the fittable alternative to the implicit offset column
(``fitting/base.py::noffset``).  As in the reference, the TZR row's phase
carries it too, so under a TZR anchor it cancels from the residuals.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import PhaseComponent
from pint_tpu_torch.models.parameter import floatParameter
from pint_tpu_torch.ops.dd import DD


class PhaseOffset(PhaseComponent):
    register = True
    category = "phase_offset"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("PHOFF", units="cycles"))

    def phase_term(self, pdict, bundle, delay):
        return DD.from_float(-pdict["PHOFF"] * torch.ones_like(
            bundle.freq_mhz))
