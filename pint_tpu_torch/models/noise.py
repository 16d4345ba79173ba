"""Noise components: white rescaling, ECORR and power-law red noise.

Counterpart of ``pint_tpu/models/noise.py`` for three of its noise
components, through the same two consumer interfaces:

  scaled_sigma(pdict, bundle, sigma_s) -> per-TOA white sigma (seconds)
  basis_weight(pdict, bundle) -> (basis (n, k), weight (k,)) or None

The correlated covariance never forms as n x n: it enters as
C = N + T phi T^T with k << n.  The red-noise sin/cos basis depends only
on the TOA times, so it is computed once on the host in IEEE f64 numpy
(:func:`host_fourier_basis`) and rides in the bundle's mask columns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.constants import F_YR, SECS_PER_DAY
from pint_tpu_torch.models.component import NoiseComponent
from pint_tpu_torch.models.parameter import floatParameter, maskParameter
from pint_tpu_torch.ops.scalarmath import power_p

#: largest gap between two TOAs of one ECORR observing epoch (seconds)
ECORR_EPOCH_GAP_S = 10.0

#: log10 of the static power-law constant f_yr^-3 / (12 pi^2), folded into
#: the amplitude exponent so no tiny intermediate is ever formed
_LOG10_PL_K = math.log10(F_YR ** -3.0 / (12.0 * math.pi * math.pi))


class ScaleToaError(NoiseComponent):
    """sigma' = EFAC * sqrt(sigma^2 + EQUAD^2) over mask selections
    (tempo2 convention)."""

    category = "scale_toa_error"

    def __init__(self):
        super().__init__()
        self.efac_params: list[str] = []
        self.equad_params: list[str] = []
        self.tneq_params: list[str] = []

    def add_efac(self, idx: int):
        name = f"EFAC{idx}"
        self.efac_params.append(name)
        return self.add_param(
            maskParameter(name, aliases=("T2EFAC",))
        )

    def add_equad(self, idx: int):
        name = f"EQUAD{idx}"
        self.equad_params.append(name)
        return self.add_param(
            maskParameter(name, units="us", aliases=("T2EQUAD",),
                          scale_to_internal=1e-6)
        )

    def add_tneq(self, idx: int):
        """TNEQ: log10(EQUAD/s)."""
        name = f"TNEQ{idx}"
        self.tneq_params.append(name)
        return self.add_param(
            maskParameter(name, units="log10(s)")
        )

    def mask_families(self):
        return {
            "EFAC": self.add_efac,
            "T2EFAC": self.add_efac,
            "EQUAD": self.add_equad,
            "T2EQUAD": self.add_equad,
            "TNEQ": self.add_tneq,
        }

    def scaled_sigma(self, pdict, bundle, sigma_s):
        equad2 = torch.zeros_like(sigma_s)
        for n in self.equad_params:
            equad2 = equad2 + torch.square(pdict[n]) * bundle.masks[n]
        for n in self.tneq_params:
            equad2 = equad2 + torch.square(
                power_p(10.0, pdict[n])
            ) * bundle.masks[n]
        efac = torch.ones_like(sigma_s)
        for n in self.efac_params:
            # masked multiplicative: efac where selected, 1 elsewhere
            efac = efac * (1.0 + (pdict[n] - 1.0) * bundle.masks[n])
        return efac * torch.sqrt(torch.square(sigma_s) + equad2)


def quantize_epochs(mjd: np.ndarray, select: np.ndarray,
                    gap_s: float = ECORR_EPOCH_GAP_S) -> np.ndarray:
    """Host-side (n, n_epoch) 0/1 quantization matrix U grouping the
    selected TOAs into observing epochs: a gap above ``gap_s`` starts a
    new epoch."""
    n = len(mjd)
    idx = np.flatnonzero(select)
    if idx.size == 0:
        return np.zeros((n, 0))
    order = idx[np.argsort(mjd[idx])]
    cols = []
    current = [order[0]]
    for i in order[1:]:
        if (mjd[i] - mjd[current[-1]]) * SECS_PER_DAY > gap_s:
            cols.append(current)
            current = [i]
        else:
            current.append(i)
    cols.append(current)
    U = np.zeros((n, len(cols)))
    for j, members in enumerate(cols):
        U[members, j] = 1.0
    return U


class EcorrNoise(NoiseComponent):
    """Per-epoch fully correlated white noise (ECORR): basis = the epoch
    quantization matrix U, weight = ECORR^2 per epoch."""

    category = "ecorr_noise"
    introduces_correlated_errors = True

    def __init__(self):
        super().__init__()
        self.ecorr_params: list[str] = []

    def add_ecorr(self, idx: int):
        name = f"ECORR{idx}"
        self.ecorr_params.append(name)
        return self.add_param(
            maskParameter(name, units="us", aliases=("T2ECORR",),
                          scale_to_internal=1e-6)
        )

    def mask_families(self):
        return {"ECORR": self.add_ecorr, "T2ECORR": self.add_ecorr}

    def basis_keys(self) -> list[str]:
        return [f"{n}:U" for n in self.ecorr_params]

    def extra_masks(self, toas) -> dict:
        """Quantization matrices, computed once at compile time."""
        mjd = np.asarray(toas["tdb_day"], np.float64) + (
            np.asarray(toas["tdb_sec_hi"], np.float64)
            + np.asarray(toas["tdb_sec_lo"], np.float64)
        ) / SECS_PER_DAY
        return {f"{n}:U": quantize_epochs(mjd, self.params[n].select(toas))
                for n in self.ecorr_params}

    def basis_weight(self, pdict, bundle):
        bases, weights = [], []
        for n in self.ecorr_params:
            U = bundle.masks[f"{n}:U"]
            if U.shape[1] == 0:
                continue
            bases.append(U)
            weights.append(torch.square(pdict[n]) * torch.ones_like(U[0]))
        if not bases:
            return None
        return torch.cat(bases, dim=1), torch.cat(weights)


def _toa_seconds(bundle) -> torch.Tensor:
    """Per-TOA seconds from the first TOA's day (f64; harmonic phases
    need only ~1e-9 relative precision)."""
    day0 = bundle.tdb_day[0]
    return (bundle.tdb_day - day0) * 86400.0 + bundle.tdb_sec.to_float()


def fourier_freqs(bundle, nharm: int):
    """Harmonic layout: (t_seconds (n,), freqs (nharm,), tspan)."""
    t = _toa_seconds(bundle)
    tspan = torch.max(t) - torch.min(t)
    j = torch.arange(1, nharm + 1, dtype=torch.float64, device=t.device)
    return t, j / tspan, tspan


def fourier_basis(bundle, nharm: int, mask_key: str | None = None):
    """(n, 2*nharm) [sin | cos] design matrix and its frequencies (Hz).
    Takes the host-precomputed basis from the bundle when present, and
    evaluates it on the device otherwise."""
    t, f, tspan = fourier_freqs(bundle, nharm)
    F = bundle.masks.get(mask_key) if mask_key else None
    if F is None:
        arg = 2.0 * math.pi * t[:, None] * f[None, :]
        F = torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)
    return F, torch.cat([f, f]), tspan


def host_fourier_basis(toas, nharm: int) -> np.ndarray:
    """Host IEEE-f64 numpy [sin | cos] basis from a TOA table's TDB
    columns, computed once per dataset at compile time."""
    day = np.asarray(toas["tdb_day"], dtype=np.float64)
    sec = np.asarray(toas["tdb_sec_hi"], np.float64) + np.asarray(
        toas["tdb_sec_lo"], np.float64
    )
    t = (day - day[0]) * 86400.0 + sec
    tspan = t.max() - t.min()
    f = np.arange(1, nharm + 1, dtype=np.float64) / tspan
    arg = 2.0 * np.pi * t[:, None] * f[None, :]
    return np.concatenate([np.sin(arg), np.cos(arg)], axis=1)


def powerlaw_phi(f, tspan, log10_amp, gamma):
    """Power-law PSD weights phi_j (s^2), enterprise convention:
    phi_j = A^2/(12 pi^2) f_yr^(gamma-3) f_j^(-gamma) / Tspan.

    The amplitude factor is formed in log space with the static constant
    folded in (A^2 alone underflows at log10_amp <= -19), and the result
    is floored at 1e-30 s^2 so 1/phi stays finite — the JAX package's
    evaluation order, kept so both packages round alike."""
    amp2_k = power_p(10.0, 2.0 * log10_amp + _LOG10_PL_K)
    return torch.clamp_min(amp2_k * (f / F_YR) ** (-gamma) / tspan, 1e-30)


class PLRedNoise(NoiseComponent):
    """Power-law achromatic red noise (TNREDAMP/TNREDGAM/TNREDC)."""

    category = "pl_red_noise"
    introduces_correlated_errors = True

    def __init__(self):
        super().__init__()
        self.add_param(
            floatParameter("TNREDAMP", units="log10(strain)",
                           aliases=("TNRedAmp",))
        )
        self.add_param(floatParameter("TNREDGAM", aliases=("TNRedGam",)))
        self.add_param(floatParameter("TNREDC", aliases=("TNRedC",)))

    def validate(self, model):
        self.require("TNREDAMP", "TNREDGAM")

    def _nharm(self):
        v = self.params["TNREDC"].value
        return int(v) if v is not None else 30

    def basis_key(self) -> str:
        return f"{self.category}:F"

    def basis_keys(self) -> list[str]:
        return [self.basis_key()]

    def extra_masks(self, toas) -> dict:
        return {self.basis_key(): host_fourier_basis(toas, self._nharm())}

    def basis_weight(self, pdict, bundle):
        F, f, tspan = fourier_basis(bundle, self._nharm(), self.basis_key())
        phi = powerlaw_phi(f, tspan, pdict["TNREDAMP"], pdict["TNREDGAM"])
        return F, phi

    def fourier_spec(self, pdict, bundle):
        """(t_seconds (n,), harmonic freqs (k,), phi (2k,)): the pure
        sin/cos structure the streaming-basis GLS step takes
        (ops/fourier.py).  Shares fourier_freqs with basis_weight, so the
        two routes agree on the harmonic layout."""
        t, f, tspan = fourier_freqs(bundle, self._nharm())
        phi = powerlaw_phi(torch.cat([f, f]), tspan, pdict["TNREDAMP"],
                           pdict["TNREDGAM"])
        return t, f, phi
