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

and :func:`make_bundle` moves it to the device once.  Absolute epochs stay
an exact day plus DD seconds, so kernels form dt against model epochs in
DD; geometry is in light-seconds, so delays are plain f64 dot products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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

    @property
    def ntoa(self) -> int:
        return self.tdb_day.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.tdb_day.device

    def dt_seconds(self, epoch_day, epoch_sec) -> DD:
        """(t_tdb - epoch) in DD seconds.  The day-difference product is
        exact in f64 for any realistic span."""
        ddays = self.tdb_day - float(epoch_day)
        big = DD.from_prod(ddays, 86400.0)
        return big + (self.tdb_sec - epoch_sec)


def make_bundle(toas, masks, device) -> TOABundle:
    """Host TOA table (+ mask/basis columns) -> device bundle."""
    n = len(toas["freq_mhz"])

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
    )
