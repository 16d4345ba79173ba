"""Solar-wind dispersion: the spherical NE_SW model and SWX.

Counterpart of ``pint_tpu/models/solar_wind.py``.  An electron density
n(r) = NE_SW (AU/r)^2 gives along the line of sight

  DM_sw = NE_SW AU^2 (pi - theta) / (d sin(theta))

with d = |obs->Sun| and theta the Sun-observer-pulsar elongation
(Edwards et al. 2006 eq. 20); delay = DM_CONST DM_sw / f^2.  NE_SW1..
are Taylor terms in (t - SWEPOCH).  SWX scales the same geometry,
normalized to 1 at 90 degrees and 1 AU, by SWXDM_#### over MJD ranges.

Zero geometry (a barycentric row, d = 0) divides by a clamped d and then
selects 0; under ``torch.func.jacfwd`` the select passes only the chosen
branch's tangent, so the unselected one's large values never reach a
design column.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.constants import (
    AU,
    DM_CONST,
    PC,
    SECS_PER_JULIAN_YEAR,
    C,
)
from pint_tpu_torch.models.astrometry import Astrometry, _dot3
from pint_tpu_torch.exceptions import MissingParameter, TimingModelError
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    prefix_index,
)
from pint_tpu_torch.ops.taylor import taylor_horner
from pint_tpu_torch.toas.bundle import table_mjd

# geometry arrives in light-seconds: AU and pc in light-seconds
_AU_LS = AU / C
_PC_LS = PC / C


def _find_astrometry(model):
    for c in model.components.values():
        if isinstance(c, Astrometry):
            return c
    return None


def elongation_geometry(astrometry, pdict, bundle):
    """-> (d, safe_d, theta, sin_t): the obs-Sun distance (light-seconds;
    d raw for the zero-geometry select, safe_d clamped for division), the
    elongation (rad) and its clamped sine."""
    psr_dir = astrometry.ssb_to_psr_xyz(pdict, bundle)
    r = bundle.obs_sun_pos_ls
    d = torch.sqrt(_dot3(r, r))
    safe_d = torch.clamp_min(d, 1e-30)
    cos_e = _dot3(r, psr_dir) / safe_d
    theta = torch.arccos(torch.clamp(cos_e, -1.0, 1.0))
    sin_t = torch.clamp_min(torch.sin(theta), 1e-9)
    return d, safe_d, theta, sin_t


def _ne_sw_deriv(k: int) -> floatParameter:
    return floatParameter(f"NE_SW{k}", units=f"cm^-3/yr^{k}",
                          scale_to_internal=SECS_PER_JULIAN_YEAR ** (-k))


class SolarWindDispersion(DelayComponent):
    register = True
    category = "solar_wind"
    prefix_patterns = ("NE_SW",)

    def __init__(self, max_terms: int = 5):
        super().__init__()
        self.add_param(floatParameter("NE_SW", units="cm^-3",
                                      aliases=("NE1AU", "SOLARN0")))
        for k in range(1, max_terms + 1):
            self.add_param(_ne_sw_deriv(k))
        self.add_param(MJDParameter("SWEPOCH"))
        self._astrometry_ref = None

    def new_prefix_param(self, name):
        k = prefix_index(name, "NE_SW")
        if k is None or k < 1:
            return None
        if f"NE_SW{k}" not in self.params:
            self.add_param(_ne_sw_deriv(k))
        return self.params[f"NE_SW{k}"]

    def setup(self, model):
        self._astrometry_ref = _find_astrometry(model)

    def _deriv_ks(self):
        return sorted(int(n[5:]) for n in self.params
                      if n.startswith("NE_SW") and n[5:].isdigit()
                      and self.params[n].value is not None)

    def validate(self, model):
        if (self.params["NE_SW"].value is not None
                and self._astrometry_ref is None):
            raise TimingModelError("SolarWindDispersion needs an astrometry "
                                   "component")
        ks = self._deriv_ks()
        if ks:
            if ks != list(range(1, ks[-1] + 1)):
                raise TimingModelError(f"non-contiguous solar-wind "
                                       f"derivatives NE_SW{ks}")
            if self.params["SWEPOCH"].value is None:
                raise MissingParameter("SolarWindDispersion", "SWEPOCH")

    def _ne_sw(self, pdict, bundle):
        coeffs = [pdict["NE_SW"]] + [pdict[f"NE_SW{k}"]
                                     for k in self._deriv_ks()]
        if len(coeffs) == 1:
            return coeffs[0]
        day, sec = pdict["SWEPOCH"]
        dt = bundle.dt_seconds(day, sec).to_float()
        return taylor_horner(dt, coeffs)

    def solar_wind_dm(self, pdict, bundle):
        """DM_sw at each TOA (pc cm^-3)."""
        d, safe_d, theta, sin_t = elongation_geometry(
            self._astrometry_ref, pdict, bundle)
        n0 = self._ne_sw(pdict, bundle)
        col = n0 * _AU_LS * _AU_LS * (math.pi - theta) / (safe_d * sin_t)
        dm = col / _PC_LS
        return torch.where(d > 0, dm, torch.zeros_like(dm))

    def dm_value(self, pdict, bundle):
        """The solar wind's share of the model DM at each TOA (pc
        cm^-3), which the wideband DM residuals subtract
        (``CompiledModel.dm_model``)."""
        if self.params["NE_SW"].value is None:
            return torch.zeros_like(bundle.freq_mhz)
        return self.solar_wind_dm(pdict, bundle)

    def delay_term(self, pdict, bundle, acc_delay):
        if self.params["NE_SW"].value is None:
            return torch.zeros_like(bundle.freq_mhz)
        dm = self.solar_wind_dm(pdict, bundle)
        return DM_CONST * dm / torch.square(bundle.freq_mhz)


class SolarWindDispersionX(DelayComponent):
    """Piecewise solar-wind DM amplitudes over MJD ranges (SWX): per range
    SWXDM_#### scales the n0 = 1 geometry normalized to 1 at 90 degrees
    elongation and 1 AU; the ranges are 0/1 columns ``SWX_####`` built on
    the host at compile time (half-open [SWXR1, SWXR2))."""

    register = True
    category = "solar_wind"
    prefix_patterns = ("SWXDM_", "SWXR1_", "SWXR2_")

    def __init__(self):
        super().__init__()
        self.swx_indices: list[int] = []
        self._astrometry_ref = None

    def add_swx_range(self, idx: int):
        self.add_param(floatParameter(f"SWXDM_{idx:04d}", units="pc/cm^3",
                                      value=0.0))
        self.add_param(floatParameter(f"SWXR1_{idx:04d}", units="MJD"))
        self.add_param(floatParameter(f"SWXR2_{idx:04d}", units="MJD"))
        self.swx_indices.append(idx)

    def new_prefix_param(self, name):
        for pref in ("SWXDM_", "SWXR1_", "SWXR2_"):
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"SWXDM_{idx:04d}" not in self.params:
                    self.add_swx_range(idx)
                return self.params[f"{pref}{idx:04d}"]
        return None

    def setup(self, model):
        self._astrometry_ref = _find_astrometry(model)
        self.swx_indices = sorted(
            int(n[6:]) for n in self.params
            if n.startswith("SWXDM_") and self.params[n].value is not None
        )

    def validate(self, model):
        if self.swx_indices and self._astrometry_ref is None:
            raise TimingModelError("SWX needs an astrometry component")
        for i in self.swx_indices:
            if (self.params[f"SWXR1_{i:04d}"].value is None
                    or self.params[f"SWXR2_{i:04d}"].value is None):
                raise MissingParameter("SolarWindDispersionX",
                                       f"SWXR1_{i:04d}/SWXR2_{i:04d}")

    def basis_keys(self) -> list[str]:
        return [f"SWX_{i:04d}" for i in self.swx_indices]

    def extra_masks(self, toas) -> dict:
        mjd = table_mjd(toas)
        return {f"SWX_{i:04d}": (
            (mjd >= self.params[f"SWXR1_{i:04d}"].value)
            & (mjd < self.params[f"SWXR2_{i:04d}"].value)).astype(np.float64)
            for i in self.swx_indices}

    def _profile(self, pdict, bundle):
        d, safe_d, theta, sin_t = elongation_geometry(
            self._astrometry_ref, pdict, bundle)
        prof = (_AU_LS * (math.pi - theta) / (safe_d * sin_t)) / (
            math.pi / 2.0)
        return torch.where(d > 0, prof, torch.zeros_like(prof))

    def dm_value(self, pdict, bundle):
        prof = self._profile(pdict, bundle)
        dm = torch.zeros_like(prof)
        for i in self.swx_indices:
            dm = dm + (pdict[f"SWXDM_{i:04d}"] * bundle.masks[f"SWX_{i:04d}"]
                       * prof)
        return dm

    def delay_term(self, pdict, bundle, acc_delay):
        if not self.swx_indices:
            return torch.zeros_like(bundle.freq_mhz)
        return DM_CONST * self.dm_value(pdict, bundle) / torch.square(
            bundle.freq_mhz)
