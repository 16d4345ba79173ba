"""Frequency-dependent profile-evolution delays: FD and FDJUMP.

Counterpart of ``pint_tpu/models/frequency_dependent.py``: FD, delay =
sum_i FDi log(nu / 1 GHz)^i; FDJump, the same terms per TOA selection
(the FDnJUMP mask families).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    floatParameter,
    maskParameter,
    prefix_index,
)


def _log_freq(bundle):
    return torch.log(bundle.freq_mhz / 1000.0)


class FD(DelayComponent):
    register = True
    category = "frequency_dependent"
    prefix_patterns = ("FD",)

    def __init__(self, max_terms: int = 9):
        super().__init__()
        for k in range(1, max_terms + 1):
            self.add_param(floatParameter(f"FD{k}", units="s"))

    def new_prefix_param(self, name):
        k = prefix_index(name, "FD")
        if k is None or k < 1:
            return None
        if f"FD{k}" not in self.params:
            self.add_param(floatParameter(f"FD{k}", units="s"))
        return self.params[f"FD{k}"]

    def _terms(self):
        return sorted(int(n[2:]) for n in self.params
                      if n[2:].isdigit() and self.params[n].value is not None)

    def delay_term(self, pdict, bundle, acc_delay):
        lf = _log_freq(bundle)
        d = torch.zeros_like(lf)
        for k in self._terms():
            d = d + pdict[f"FD{k}"] * lf**k
        return d


class FDJump(DelayComponent):
    """FDnJUMP mask families: FD-like terms on TOA selections."""

    register = True
    category = "frequency_dependent"
    MAX_ORDER = 4

    def __init__(self):
        super().__init__()
        self.fdjump_params: list[tuple[str, int]] = []

    def _add_order(self, order):
        def add(idx: int):
            name = f"FD{order}JUMP{idx}"
            self.fdjump_params.append((name, order))
            return self.add_param(maskParameter(name, units="s"))

        return add

    def mask_families(self):
        return {f"FD{k}JUMP": self._add_order(k)
                for k in range(1, self.MAX_ORDER + 1)}

    def delay_term(self, pdict, bundle, acc_delay):
        lf = _log_freq(bundle)
        d = torch.zeros_like(lf)
        for name, order in self.fdjump_params:
            d = d + pdict[name] * lf**order * bundle.masks[name]
        return d
