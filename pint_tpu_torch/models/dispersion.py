"""Dispersion delays: the DM polynomial and piecewise DMX offsets.

Counterpart of ``pint_tpu/models/dispersion.py`` (``DispersionDM``,
``DispersionDMX``, ``DMJump``): delay = K * DM(t) / f^2 with K the Tempo
constant, DM(t) a Taylor series in (t - DMEPOCH) with the factorial
convention, plus one constant DMX_#### over each MJD range [DMXR1_####,
DMXR2_####]; DMJUMPs shift only the model of wideband DM measurements.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import DM_CONST, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.exceptions import MissingParameter, TimingModelError
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    maskParameter,
    prefix_index,
)
from pint_tpu_torch.ops.taylor import taylor_horner
from pint_tpu_torch.toas.bundle import as_table, table_mjd


class DispersionDM(DelayComponent):
    register = True
    category = "dispersion_constant"
    prefix_patterns = ("DM",)

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

    def new_prefix_param(self, name):
        """DM11 and beyond: the derivatives past the preallocated ones
        (DM0 is not one)."""
        k = prefix_index(name, "DM")
        if k is None or k < 1:
            return None
        return self.add_param(floatParameter(
            f"DM{k}", units=f"pc/cm^3/yr^{k}",
            scale_to_internal=SECS_PER_JULIAN_YEAR ** (-k)))

    def validate(self, model):
        if (
            self.params["DM1"].value is not None
            and self.params["DMEPOCH"].value is None
        ):
            raise TimingModelError("DMEPOCH required when DM1 is set")
        set_ks = sorted(
            int(n[2:]) for n in self.params
            if n.startswith("DM") and n[2:].isdigit()
            and self.params[n].value is not None
        )
        if set_ks and set_ks != list(range(1, set_ks[-1] + 1)):
            raise TimingModelError(
                f"non-contiguous DM derivatives: DM{set_ks}")

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


class DispersionDMX(DelayComponent):
    """Piecewise-constant DM offsets over MJD ranges (DMX_####).

    The reference adds one masked term per range in a loop (three eager
    operators each, ~450 more per forward at 150 ranges).  Here the ranges
    are one (n, nranges) 0/1 matrix, built on the host at compile time
    (``extra_masks``), contracted with the vector of DMX values by one
    matrix product.  A TOA lies in one range, so its sum has one nonzero
    term and equals the reference's bit for bit (the summation order
    differs only where ranges overlap)."""

    register = True
    category = "dispersion_dmx"
    prefix_patterns = ("DMX_", "DMXR1_", "DMXR2_")
    _FAMILY = ("DMX_", "DMXR1_", "DMXR2_")
    mask_key = "dispersion_dmx:M"

    def __init__(self):
        super().__init__()
        self.dmx_indices: list[int] = []

    def add_dmx_range(self, idx: int):
        self.add_param(floatParameter(f"DMX_{idx:04d}", units="pc/cm^3",
                                      value=0.0))
        self.add_param(floatParameter(f"DMXR1_{idx:04d}", units="MJD"))
        self.add_param(floatParameter(f"DMXR2_{idx:04d}", units="MJD"))
        self.dmx_indices.append(idx)

    def new_prefix_param(self, name):
        for pref in self._FAMILY:
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"DMX_{idx:04d}" not in self.params:
                    self.add_dmx_range(idx)
                return self.params[f"{pref}{idx:04d}"]
        return None

    def validate(self, model):
        for i in self.dmx_indices:
            if (self.params[f"DMXR1_{i:04d}"].value is None
                    or self.params[f"DMXR2_{i:04d}"].value is None):
                raise MissingParameter(
                    "DispersionDMX", f"DMXR1_{i:04d}/DMXR2_{i:04d}",
                    f"DMX_{i:04d} is set but its MJD range bounds are not")

    def setup(self, model):
        self.dmx_indices = sorted(
            int(n[4:]) for n in self.params
            if n.startswith("DMX_") and self.params[n].value is not None
        )

    def basis_keys(self) -> list[str]:
        return [self.mask_key]

    def dmx_masks(self, toas) -> dict:
        """Each range's 0/1 mask ``DMX_####`` over a TOA table or TOAs,
        from DMXR1/DMXR2 (both ends inclusive)."""
        mjd = table_mjd(as_table(toas))
        out = {}
        for i in self.dmx_indices:
            r1 = self.params[f"DMXR1_{i:04d}"].value
            r2 = self.params[f"DMXR2_{i:04d}"].value
            out[f"DMX_{i:04d}"] = ((mjd >= r1) & (mjd <= r2)).astype(
                np.float64)
        return out

    def extra_masks(self, toas) -> dict:
        """The (n, nranges) range matrix: from the table's per-range masks
        ``DMX_####`` where it carries them (state exported by the JAX
        package), else ``dmx_masks``."""
        given = toas.get("masks") or {}
        own = self.dmx_masks(toas)
        cols = [np.asarray(given.get(n, own[n]), np.float64) for n in own]
        M = (np.stack(cols, axis=1) if cols
             else np.zeros((len(table_mjd(toas)), 0)))
        return {self.mask_key: M}

    def dm_value(self, pdict, bundle):
        M = bundle.masks[self.mask_key]
        if not self.dmx_indices:
            return torch.zeros(bundle.ntoa, dtype=M.dtype, device=M.device)
        v = torch.stack([pdict[f"DMX_{i:04d}"] for i in self.dmx_indices])
        return M @ v

    def delay_term(self, pdict, bundle, acc_delay):
        return DM_CONST * self.dm_value(pdict, bundle) / torch.square(
            bundle.freq_mhz)


class DMJump(DelayComponent):
    """Wideband DM jumps (DMJUMP mask family): they shift the model of
    the DM *measurements*, not the delay.  The delay term is zero;
    ``dm_offset`` subtracts each selected DMJUMP from the model DM that
    the wideband DM residuals compare with (``CompiledModel.dm_model``)."""

    register = True
    category = "dispersion_jump"

    def __init__(self):
        super().__init__()
        self.dmjump_params: list[str] = []

    def add_dmjump(self, idx: int) -> maskParameter:
        name = f"DMJUMP{idx}"
        self.dmjump_params.append(name)
        return self.add_param(maskParameter(name, units="pc/cm^3"))

    def mask_families(self):
        return {"DMJUMP": self.add_dmjump}

    def delay_term(self, pdict, bundle, acc_delay):
        return torch.zeros_like(bundle.freq_mhz)

    def dm_offset(self, pdict, bundle):
        off = torch.zeros_like(bundle.freq_mhz)
        for n in self.dmjump_params:
            off = off - pdict[n] * bundle.masks[n]
        return off
