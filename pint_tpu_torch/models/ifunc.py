"""Tabulated phase corrections (IFUNC).

Counterpart of ``pint_tpu/models/ifunc.py::IFunc``: IFUNC1..n are
(MJD, seconds) nodes; SIFUNC 2 interpolates them linearly, 0 and 1 take
the nearest node (``ops/interp.py``, with ``jnp.interp``'s and the
reference's end clamping).  The seconds act as a delay, applied as phase
through F0 like Wave.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.component import PhaseComponent
from pint_tpu_torch.models.parameter import (
    floatParameter,
    pairParameter,
    prefix_index,
)
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.ops.interp import interp, nearest


class IFunc(PhaseComponent):
    register = True
    category = "ifunc"
    prefix_patterns = ("IFUNC",)

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("SIFUNC", value=2.0))
        self.ifunc_indices: list[int] = []

    def new_prefix_param(self, name):
        k = prefix_index(name, "IFUNC")
        if k is None or k < 1:
            return None
        return self.add_param(pairParameter(f"IFUNC{k}", units="MJD,s"))

    def setup(self, model):
        self.ifunc_indices = sorted(
            int(n[5:]) for n in self.params
            if n.startswith("IFUNC") and n[5:].isdigit()
            and self.params[n].value is not None
        )

    def host_state(self) -> tuple:
        # the nodes and the interpolation mode are read on the host
        return (self.params["SIFUNC"].value,
                tuple(tuple(self.params[f"IFUNC{i}"].value)
                      for i in self.ifunc_indices))

    def phase_term(self, pdict, bundle, delay):
        if not self.ifunc_indices:
            return DD.zeros(bundle.ntoa, bundle.device)
        nodes = np.array(
            [self.params[f"IFUNC{i}"].value for i in self.ifunc_indices])
        order = np.argsort(nodes[:, 0])
        xs, ys = nodes[order, 0], nodes[order, 1]
        t = bundle.tdb_day + bundle.tdb_sec.to_float() / SECS_PER_DAY
        if int(self.params["SIFUNC"].value) == 2:
            val = interp(t, xs, ys)
        else:
            val = nearest(t, xs, ys)
        return DD.from_float(-val * pdict["F0"].to_float())
