"""Piecewise spindown: independent spin corrections over MJD intervals.

Counterpart of ``pint_tpu/models/piecewise.py::PiecewiseSpindown``: for
TOAs with PWSTART_i <= MJD < PWSTOP_i it adds

  phase_i = PWPH_i + PWF0_i dt + PWF1_i dt^2/2 + PWF2_i dt^3/6,
  dt = t - PWEP_i - delay (seconds)

on top of the global spindown.  Range membership is a 0/1 column per
piece, built on the host at compile time (``PW_<i>``).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.exceptions import MissingParameter, TimingModelError
from pint_tpu_torch.models.component import PhaseComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    prefix_index,
)
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.toas.bundle import table_mjd

_FAMS = ("PWEP_", "PWPH_", "PWF0_", "PWF1_", "PWF2_", "PWSTART_", "PWSTOP_")


class PiecewiseSpindown(PhaseComponent):
    register = True
    category = "piecewise_spindown"
    prefix_patterns = _FAMS

    def __init__(self):
        super().__init__()
        self.piece_indices: list[int] = []

    def add_piece(self, idx: int):
        self.add_param(MJDParameter(f"PWEP_{idx}"))
        self.add_param(floatParameter(f"PWPH_{idx}", units="cycles",
                                      value=0.0))
        self.add_param(floatParameter(f"PWF0_{idx}", units="Hz", value=0.0))
        self.add_param(floatParameter(f"PWF1_{idx}", units="Hz/s",
                                      value=0.0))
        self.add_param(floatParameter(f"PWF2_{idx}", units="Hz/s^2",
                                      value=0.0))
        self.add_param(floatParameter(f"PWSTART_{idx}", units="MJD"))
        self.add_param(floatParameter(f"PWSTOP_{idx}", units="MJD"))
        self.piece_indices.append(idx)

    def new_prefix_param(self, name):
        for pref in _FAMS:
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"PWEP_{idx}" not in self.params:
                    self.add_piece(idx)
                return self.params[f"{pref}{idx}"]
        return None

    def setup(self, model):
        # a piece exists when any of its parameters is set, so validate
        # names a missing PWEP/PWSTART/PWSTOP rather than dropping it
        idx = set()
        for n, p in self.params.items():
            if p.value is None:
                continue
            for pref in _FAMS:
                if n.startswith(pref) and n[len(pref):].isdigit():
                    idx.add(int(n[len(pref):]))
        self.piece_indices = sorted(idx)

    def validate(self, model):
        for i in self.piece_indices:
            if self.params[f"PWEP_{i}"].value is None:
                raise MissingParameter("PiecewiseSpindown", f"PWEP_{i}")
            if (self.params[f"PWSTART_{i}"].value is None
                    or self.params[f"PWSTOP_{i}"].value is None):
                raise TimingModelError(
                    f"piecewise-spindown piece {i} missing PWSTART/PWSTOP")

    def basis_keys(self) -> list[str]:
        return [f"PW_{i}" for i in self.piece_indices]

    def extra_masks(self, toas) -> dict:
        mjd = table_mjd(toas)
        return {f"PW_{i}": ((mjd >= self.params[f"PWSTART_{i}"].value)
                            & (mjd < self.params[f"PWSTOP_{i}"].value)
                            ).astype(np.float64)
                for i in self.piece_indices}

    def phase_term(self, pdict, bundle, delay):
        total = torch.zeros_like(bundle.freq_mhz)
        for i in self.piece_indices:
            day, sec = pdict[f"PWEP_{i}"]
            dt = bundle.dt_seconds(day, sec).to_float() - delay
            ph = (pdict[f"PWPH_{i}"] + pdict[f"PWF0_{i}"] * dt
                  + pdict[f"PWF1_{i}"] * dt * dt / 2.0
                  + pdict[f"PWF2_{i}"] * (dt * dt * dt) / 6.0)
            total = total + bundle.masks[f"PW_{i}"] * ph
        return DD.from_float(total)
