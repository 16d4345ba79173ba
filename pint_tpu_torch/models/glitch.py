"""Glitches: a phase step plus spin-up and decaying terms per epoch.

Counterpart of ``pint_tpu/models/glitch.py::Glitch``.  For glitch i, at
dt = t - GLEP_i - delay > 0 (seconds):

  phase_i = GLPH_i + GLF0_i dt + GLF1_i dt^2/2 + GLF2_i dt^3/6
            + GLF0D_i GLTD_i (1 - exp(-dt/GLTD_i))

The terms are small next to the spin phase, so f64 sums into the DD
phase are exact to far below a nanosecond.  Before the epoch dt is
replaced by 0 ahead of the exponential, so no large exp or its tangent
is ever formed there.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.exceptions import MissingParameter
from pint_tpu_torch.models.component import PhaseComponent
from pint_tpu_torch.models.parameter import floatParameter, prefix_index
from pint_tpu_torch.ops.dd import DD

_FAMS = ("GLEP_", "GLPH_", "GLF0_", "GLF1_", "GLF2_", "GLF0D_", "GLTD_")


class Glitch(PhaseComponent):
    register = True
    category = "glitch"
    prefix_patterns = _FAMS

    def __init__(self):
        super().__init__()
        self.glitch_indices: list[int] = []

    def add_glitch(self, idx: int):
        self.add_param(floatParameter(f"GLEP_{idx}", units="MJD"))
        self.add_param(floatParameter(f"GLPH_{idx}", units="cycles",
                                      value=0.0))
        self.add_param(floatParameter(f"GLF0_{idx}", units="Hz", value=0.0))
        self.add_param(floatParameter(f"GLF1_{idx}", units="Hz/s",
                                      value=0.0))
        self.add_param(floatParameter(f"GLF2_{idx}", units="Hz/s^2",
                                      value=0.0))
        self.add_param(floatParameter(f"GLF0D_{idx}", units="Hz",
                                      value=0.0))
        self.add_param(floatParameter(f"GLTD_{idx}", units="d",
                                      scale_to_internal=SECS_PER_DAY))
        self.glitch_indices.append(idx)

    def new_prefix_param(self, name):
        for pref in _FAMS:
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"GLEP_{idx}" not in self.params:
                    self.add_glitch(idx)
                return self.params[f"{pref}{idx}"]
        return None

    def setup(self, model):
        self.glitch_indices = sorted(
            int(n[5:]) for n in self.params
            if n.startswith("GLEP_") and self.params[n].value is not None
        )

    def validate(self, model):
        for i in self.glitch_indices:
            if self.params[f"GLEP_{i}"].value is None:
                raise MissingParameter("Glitch", f"GLEP_{i}")

    def host_state(self) -> tuple:
        # which glitches have a decay term shapes the kernel
        return tuple(
            self.params[f"GLTD_{i}"].value is not None
            and float(self.params[f"GLTD_{i}"].value) != 0.0
            for i in self.glitch_indices)

    def phase_term(self, pdict, bundle, delay):
        total = torch.zeros_like(bundle.freq_mhz)
        for i in self.glitch_indices:
            dt = ((bundle.tdb_day - pdict[f"GLEP_{i}"]) * SECS_PER_DAY
                  + bundle.tdb_sec.to_float())
            dt = dt - delay
            on = dt > 0.0
            dtp = torch.where(on, dt, torch.zeros_like(dt))
            ph = (pdict[f"GLPH_{i}"] + pdict[f"GLF0_{i}"] * dtp
                  + pdict[f"GLF1_{i}"] * dtp * dtp / 2.0
                  + pdict[f"GLF2_{i}"] * (dtp * dtp * dtp) / 6.0)
            # GLTD 0 (the tempo convention for no decay) must not divide
            td_host = self.params[f"GLTD_{i}"].value
            if td_host is not None and float(td_host) != 0.0:
                td = pdict[f"GLTD_{i}"]
                ph = ph + pdict[f"GLF0D_{i}"] * td * (
                    1.0 - torch.exp(-dtp / td))
            total = total + torch.where(on, ph, torch.zeros_like(ph))
        return DD.from_float(total)
