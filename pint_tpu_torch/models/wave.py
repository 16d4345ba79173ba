"""Sinusoidal whitening terms: Wave, and the WaveX, DMWaveX and CMWaveX
families.

Counterpart of ``pint_tpu/models/wave.py``.  Wave: the fundamental
WAVE_OM (rad/day) and harmonics WAVEn = (sin, cos) amplitudes in seconds,
a delay applied as phase through F0.  WaveX: explicit-frequency
(WXFREQ_, 1/day) sinusoid delays; DMWaveX scales them by DM_CONST / f^2
(amplitudes in pc cm^-3), CMWaveX by DM_CONST / f^CMIDX (CMIDX from
ChromaticCM, 4 without it).
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.constants import DM_CONST, SECS_PER_DAY
from pint_tpu_torch.models.component import DelayComponent, PhaseComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    pairParameter,
    prefix_index,
)
from pint_tpu_torch.ops.dd import DD

TWOPI = 2.0 * math.pi


def _days_since(bundle, epoch):
    day, sec = epoch
    return (bundle.tdb_day - day) + (
        bundle.tdb_sec - sec).to_float() / SECS_PER_DAY


def _epoch_from_pepoch(param, model):
    """An unset WAVEEPOCH / WXEPOCH defaults to PEPOCH."""
    spin = getattr(model, "components", {}).get("Spindown")
    if param.value is None and spin is not None:
        pep = spin.params["PEPOCH"].value
        if pep is not None:
            param.value = pep


class Wave(PhaseComponent):
    """WAVE_OM + WAVEn (sin, cos) seconds; a positive amplitude is extra
    delay, so the phase decreases."""

    register = True
    category = "wave"
    prefix_patterns = ("WAVE",)

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("WAVE_OM", units="rad/d"))
        self.add_param(MJDParameter("WAVEEPOCH"))
        self.wave_indices: list[int] = []

    def new_prefix_param(self, name):
        k = prefix_index(name, "WAVE")
        if k is None or k < 1:
            return None
        return self.add_param(pairParameter(f"WAVE{k}", units="s"))

    def setup(self, model):
        self.wave_indices = sorted(
            int(n[4:]) for n in self.params
            if n.startswith("WAVE") and n[4:].isdigit()
            and self.params[n].value is not None
        )
        _epoch_from_pepoch(self.params["WAVEEPOCH"], model)

    def validate(self, model):
        if self.wave_indices:
            self.require("WAVE_OM", "WAVEEPOCH")

    def phase_term(self, pdict, bundle, delay):
        if not self.wave_indices:
            return DD.zeros(bundle.ntoa, bundle.device)
        td = _days_since(bundle, pdict["WAVEEPOCH"])
        om = pdict["WAVE_OM"]
        wave = torch.zeros_like(td)
        for k in self.wave_indices:
            a, b = pdict[f"WAVE{k}"]
            arg = k * om * td
            wave = wave + a * torch.sin(arg) + b * torch.cos(arg)
        return DD.from_float(-wave * pdict["F0"].to_float())


class WaveXBase(DelayComponent):
    """Explicit-frequency sinusoid delays, times a chromatic factor."""

    prefixes = ("WXFREQ_", "WXSIN_", "WXCOS_")
    epoch_name = "WXEPOCH"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter(self.epoch_name))
        self.indices: list[int] = []

    @property
    def prefix_patterns(self):
        return self.prefixes

    def _add_index(self, idx: int):
        fr, sn, cs = self.prefixes
        self.add_param(floatParameter(f"{fr}{idx:04d}", units="1/d"))
        self.add_param(floatParameter(f"{sn}{idx:04d}", units="s",
                                      value=0.0))
        self.add_param(floatParameter(f"{cs}{idx:04d}", units="s",
                                      value=0.0))
        self.indices.append(idx)

    def new_prefix_param(self, name):
        for pref in self.prefixes:
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"{self.prefixes[0]}{idx:04d}" not in self.params:
                    self._add_index(idx)
                return self.params[f"{pref}{idx:04d}"]
        return None

    def setup(self, model):
        fr = self.prefixes[0]
        self.indices = sorted(
            int(n[len(fr):]) for n in self.params
            if n.startswith(fr) and self.params[n].value is not None
        )
        _epoch_from_pepoch(self.params[self.epoch_name], model)

    def _chromatic_factor(self, pdict, bundle):
        return 1.0

    def delay_term(self, pdict, bundle, acc_delay):
        if not self.indices:
            return torch.zeros_like(bundle.freq_mhz)
        td = _days_since(bundle, pdict[self.epoch_name])
        fr, sn, cs = self.prefixes
        d = torch.zeros_like(td)
        for i in self.indices:
            arg = TWOPI * pdict[f"{fr}{i:04d}"] * td
            d = (d + pdict[f"{sn}{i:04d}"] * torch.sin(arg)
                 + pdict[f"{cs}{i:04d}"] * torch.cos(arg))
        return d * self._chromatic_factor(pdict, bundle)


class WaveX(WaveXBase):
    register = True
    category = "wave"


class DMWaveX(WaveXBase):
    """Amplitudes in pc cm^-3; the delay scales as DM_CONST / f^2."""

    register = True
    category = "dispersion_dmx"
    prefixes = ("DMWXFREQ_", "DMWXSIN_", "DMWXCOS_")
    epoch_name = "DMWXEPOCH"

    def _chromatic_factor(self, pdict, bundle):
        return DM_CONST / torch.square(bundle.freq_mhz)


class CMWaveX(WaveXBase):
    """Chromatic (f^-CMIDX) sinusoids."""

    register = True
    category = "chromatic"
    prefixes = ("CMWXFREQ_", "CMWXSIN_", "CMWXCOS_")
    epoch_name = "CMWXEPOCH"

    def _chromatic_factor(self, pdict, bundle):
        return DM_CONST / bundle.freq_mhz ** pdict.get("CMIDX", 4.0)
