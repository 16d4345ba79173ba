"""Phase and delay jumps over TOA subsets.

Counterpart of ``pint_tpu/models/jump.py``: ``PhaseJump`` (the JUMP mask
family; a JUMP of J seconds takes J * F0 cycles off the phase of the
selected TOAs) and ``DelayJump`` (JUMP as seconds of delay, the tempo1
convention; not chosen by the builder, as in the reference).  The
selections are 0/1 columns made on the host at compile time.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import DelayComponent, PhaseComponent
from pint_tpu_torch.models.parameter import maskParameter
from pint_tpu_torch.ops.dd import DD


class _JumpFamily:
    def _init_jumps(self):
        self.jump_params: list[str] = []

    def add_jump(self, idx: int) -> maskParameter:
        name = f"JUMP{idx}"
        self.jump_params.append(name)
        return self.add_param(maskParameter(name, units="s"))

    def mask_families(self):
        return {"JUMP": self.add_jump}

    def _jump_seconds(self, pdict, bundle):
        s = torch.zeros(bundle.ntoa, dtype=bundle.freq_mhz.dtype,
                        device=bundle.device)
        for n in self.jump_params:
            s = s + pdict[n] * bundle.masks[n]
        return s


class PhaseJump(_JumpFamily, PhaseComponent):
    register = True
    category = "phase_jump"

    def __init__(self):
        super().__init__()
        self._init_jumps()

    def phase_term(self, pdict, bundle, delay):
        f0 = pdict["F0"]
        f0 = f0.to_float() if isinstance(f0, DD) else f0
        # J seconds of jump = -J * F0 cycles (the delay convention)
        return DD.from_float(-self._jump_seconds(pdict, bundle) * f0)


class DelayJump(_JumpFamily, DelayComponent):
    category = "jump_delay"

    def __init__(self):
        super().__init__()
        self._init_jumps()

    def delay_term(self, pdict, bundle, acc_delay):
        return self._jump_seconds(pdict, bundle)
