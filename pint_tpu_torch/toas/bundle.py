"""TOABundle: the device-resident tensor view of a TOA table.

Counterpart of ``pint_tpu/toas/bundle.py``.  Host data arrives as a TOA
*table*: a plain dict of numpy columns in the bundle's own units

  tdb_day (n,)            exact integer MJD(TDB)
  tdb_sec_hi, tdb_sec_lo  (n,) seconds of TDB day as a double-double
  freq_mhz, error_us      (n,)
  ssb_obs_pos_ls          (n, 3) SSB->observatory, light-seconds
  ssb_obs_vel_c           (n, 3) observatory velocity / c
  obs_sun_pos_ls          (n, 3) observatory->Sun, light-seconds
  obs_planet_pos_ls       dict body -> (n, 3), light-seconds
  pulse_number, padd      (n,) (NaN pulse numbers: untracked)
  flags                   optional list of per-TOA flag dicts
  masks                   optional dict of precomputed (n,) or (n, k)
                          columns (mask selections, noise bases)
  tzr                     optional one-row table of the same layout: the
                          TZR arrival of a model with an AbsPhase anchor
  dm_meas, dm_err         optional (n,) wideband DM measurements and their
                          errors (pc cm^-3); without them, taken from the
                          ``pp_dm`` / ``pp_dme`` flags when every TOA
                          carries a ``pp_dm`` (:func:`is_wideband`)

and :func:`make_bundle` moves it to the device once.  Absolute epochs stay
an exact day plus DD seconds, so kernels form dt against model epochs in
DD; geometry is in light-seconds, so delays are plain f64 dot products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.ops.dd import DD, F64


class TOABundle(NamedTuple):
    tdb_day: torch.Tensor  # (n,) f64 exact integer MJD(TDB)
    tdb_sec: DD  # (n,) seconds of TDB day
    freq_mhz: torch.Tensor
    error_us: torch.Tensor
    ssb_obs_pos_ls: torch.Tensor  # (n, 3)
    ssb_obs_vel_c: torch.Tensor  # (n, 3)
    obs_sun_pos_ls: torch.Tensor  # (n, 3)
    obs_planet_pos_ls: dict
    pulse_number: torch.Tensor
    padd: torch.Tensor
    masks: dict
    # the one-row bundle of the model's TZR arrival (AbsPhase), or None
    tzr: Optional["TOABundle"] = None
    # wideband DM measurements and errors (pc cm^-3); None for narrowband
    dm_meas: Optional[torch.Tensor] = None
    dm_err: Optional[torch.Tensor] = None

    @property
    def ntoa(self) -> int:
        return self.tdb_day.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.tdb_day.device

    def dt_seconds(self, epoch_day, epoch_sec) -> DD:
        """(t_tdb - epoch) in DD seconds.  ``epoch_day`` is the exact
        day number, a host number or an f64 tensor (a model's reference
        epochs are device scalars, so a PTA batch can give each pulsar
        its own); both give the same f64 difference.  The day-difference
        product is exact in f64 for any realistic span."""
        if not isinstance(epoch_day, torch.Tensor):
            epoch_day = float(epoch_day)
        ddays = self.tdb_day - epoch_day
        big = DD.from_prod(ddays, 86400.0)
        return big + (self.tdb_sec - epoch_sec)


def is_wideband(toas) -> bool:
    """Whether every TOA of a host TOA table carries a wideband DM
    measurement: a ``dm_meas`` column without NaN, or a ``pp_dm`` flag
    on every TOA (the reference's ``TOAs.is_wideband``).  On a bundle:
    whether it holds DM measurements."""
    if isinstance(toas, TOABundle):
        return toas.dm_meas is not None
    if toas.get("dm_meas") is not None:
        dm = np.asarray(toas["dm_meas"], np.float64)
        return dm.size > 0 and not np.isnan(dm).any()
    flags = toas.get("flags")
    return bool(flags) and all("pp_dm" in f for f in flags)


def get_dm_measurements(toas):
    """(dm, dm_err) of a host TOA table, pc cm^-3: its ``dm_meas`` /
    ``dm_err`` columns, else its ``pp_dm`` / ``pp_dme`` flags, NaN where
    a TOA has none.  On a bundle, its two tensors as numpy arrays."""
    if isinstance(toas, TOABundle):
        return tuple(
            np.full(toas.ntoa, np.nan) if v is None
            else v.detach().cpu().numpy() for v in (toas.dm_meas, toas.dm_err))
    n = len(toas["freq_mhz"])
    if toas.get("dm_meas") is not None:
        dme = toas.get("dm_err")
        return (np.asarray(toas["dm_meas"], np.float64),
                np.full(n, np.nan) if dme is None
                else np.asarray(dme, np.float64))
    flags = toas.get("flags") or [{}] * n
    return tuple(
        np.array([float(f.get(key, np.nan)) for f in flags])
        for key in ("pp_dm", "pp_dme"))


def make_bundle(toas, masks, device) -> TOABundle:
    """Host TOA table (+ mask/basis columns) -> device bundle."""
    n = len(toas["freq_mhz"])
    dm_meas, dm_err = (get_dm_measurements(toas) if is_wideband(toas)
                       else (None, None))

    def opt(v):
        return None if v is None else torch.as_tensor(
            np.asarray(v, np.float64), dtype=F64, device=device)

    def col(key, shape=None, fill=0.0):
        v = toas.get(key)
        if v is None:
            v = np.full(shape or (n,), fill)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=F64,
                               device=device)

    return TOABundle(
        tdb_day=col("tdb_day"),
        tdb_sec=DD(col("tdb_sec_hi"), col("tdb_sec_lo")),
        freq_mhz=col("freq_mhz"),
        error_us=col("error_us"),
        ssb_obs_pos_ls=col("ssb_obs_pos_ls", (n, 3)),
        ssb_obs_vel_c=col("ssb_obs_vel_c", (n, 3)),
        obs_sun_pos_ls=col("obs_sun_pos_ls", (n, 3)),
        obs_planet_pos_ls={
            k: torch.as_tensor(np.asarray(v, np.float64), dtype=F64,
                               device=device)
            for k, v in (toas.get("obs_planet_pos_ls") or {}).items()
        },
        pulse_number=col("pulse_number", fill=np.nan),
        padd=col("padd"),
        masks={
            k: torch.as_tensor(np.asarray(v, np.float64), dtype=F64,
                               device=device)
            for k, v in masks.items()
        },
        dm_meas=opt(dm_meas),
        dm_err=opt(dm_err),
    )


def table_mjd(toas) -> np.ndarray:
    """MJD(TDB) of each row of a host TOA table, as f64 days (the range
    and epoch selections of the mask columns)."""
    return np.asarray(toas["tdb_day"], np.float64) + (
        np.asarray(toas["tdb_sec_hi"], np.float64)
        + np.asarray(toas["tdb_sec_lo"], np.float64)) / SECS_PER_DAY


def take_rows(toas: dict, idx) -> dict:
    """The host TOA table with its TOAs reordered (or selected) by the
    integer index array ``idx``: every per-TOA column, the flags and the
    precomputed masks taken together, so that a model compiled on the
    result sees the same TOAs in the new order."""
    idx = np.asarray(idx)
    n = len(toas["freq_mhz"])
    out = {}
    for key, v in toas.items():
        if key == "flags":
            out[key] = None if v is None else [v[i] for i in idx]
        elif key in ("obs_planet_pos_ls", "masks"):
            out[key] = None if v is None else {
                k: np.asarray(a)[idx] for k, a in v.items()}
        elif isinstance(v, np.ndarray) and v.shape[:1] == (n,):
            out[key] = v[idx]
        else:
            out[key] = v
    return out
