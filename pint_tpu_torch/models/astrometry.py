"""Equatorial astrometry: Roemer + parallax delays from sky position.

Counterpart of ``pint_tpu/models/astrometry.py::AstrometryEquatorial``:
SSB->pulsar unit vector with linear proper motion from POSEPOCH, Roemer
delay -r_obs.n, parallax delay px (|r|^2 - (r.n)^2) / (2 AU).  Internal
units: angles rad, proper motions rad/s, PX rad; positions arrive in
light-seconds, so the delays are plain f64 dot products.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import (
    AU_LIGHT_SEC,
    MAS_TO_RAD,
    SECS_PER_JULIAN_YEAR,
)
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    AngleParameter,
    MJDParameter,
    floatParameter,
)
from pint_tpu_torch.ops.scalarmath import cos_p, sin_p

_MAS_YR = MAS_TO_RAD / SECS_PER_JULIAN_YEAR


class AstrometryEquatorial(DelayComponent):
    category = "astrometry"
    triggers = ("RAJ", "DECJ", "RA", "DEC", "PMRA", "PMDEC")

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("POSEPOCH"))
        self.add_param(
            floatParameter("PX", units="mas", scale_to_internal=MAS_TO_RAD)
        )
        self.add_param(
            AngleParameter("RAJ", units="H:M:S", aliases=("RA",),
                           frozen=False)
        )
        self.add_param(
            AngleParameter("DECJ", units="D:M:S", aliases=("DEC",),
                           frozen=False)
        )
        self.add_param(
            floatParameter("PMRA", units="mas/yr", scale_to_internal=_MAS_YR)
        )
        self.add_param(
            floatParameter("PMDEC", units="mas/yr",
                           scale_to_internal=_MAS_YR)
        )

    def validate(self, model):
        self.require("RAJ", "DECJ")

    def _dt_pos(self, pdict, bundle):
        """Seconds from POSEPOCH (f64 is ample for proper-motion terms);
        the first TOA's day when POSEPOCH is unset."""
        if self.params["POSEPOCH"].value is not None:
            day, sec = pdict["POSEPOCH"]
        else:
            day, sec = float(bundle.tdb_day[0]), 0.0
        return bundle.dt_seconds(day, sec).to_float()

    def ssb_to_psr_xyz(self, pdict, bundle):
        """Unit vector(s) SSB->pulsar, (3,) or (n, 3) with proper motion."""
        ra0, dec0 = pdict["RAJ"], pdict["DECJ"]
        pmra = pdict.get("PMRA")
        pmdec = pdict.get("PMDEC")
        dt = None
        if pmra is not None or pmdec is not None:
            dt = self._dt_pos(pdict, bundle)
        dec = dec0 if pmdec is None else dec0 + pmdec * dt
        cosd = cos_p(dec)
        ra = ra0 if pmra is None else ra0 + pmra * dt / cos_p(dec0)
        return torch.stack(
            torch.broadcast_tensors(
                cos_p(ra) * cosd, sin_p(ra) * cosd, sin_p(dec)
            ),
            dim=-1,
        )

    def delay_term(self, pdict, bundle, acc_delay):
        n = self.ssb_to_psr_xyz(pdict, bundle)
        r = bundle.ssb_obs_pos_ls  # light-seconds
        rn = torch.sum(r * n, dim=-1)
        roemer = -rn
        px = pdict.get("PX")
        if px is None:
            return roemer
        r2 = torch.sum(r * r, dim=-1)
        plx = px / (2.0 * AU_LIGHT_SEC) * (r2 - rn * rn)
        return roemer + plx
