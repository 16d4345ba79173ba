"""Astrometry: Roemer + parallax delays from sky position.

Counterpart of ``pint_tpu/models/astrometry.py`` (``Astrometry``,
``AstrometryEquatorial``, ``AstrometryEcliptic``): SSB->pulsar unit
vector with linear proper motion from POSEPOCH, Roemer delay -r_obs.n,
parallax delay px (|r|^2 - (r.n)^2) / (2 AU); and, for DDK, the sky
basis and proper motion in the component's own frame.  Internal units:
angles rad, proper motions rad/s, PX rad; positions arrive in
light-seconds, so the delays are plain f64 dot products.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.constants import (
    AU_LIGHT_SEC,
    MAS_TO_RAD,
    OBL_J2000,
    SECS_PER_JULIAN_YEAR,
)
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    AngleParameter,
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.ops.scalarmath import cos_p, sin_p

_MAS_YR = MAS_TO_RAD / SECS_PER_JULIAN_YEAR


class Astrometry(DelayComponent):
    """Base: POSEPOCH, PX and the delays from ssb_to_psr_xyz."""

    category = "astrometry"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("POSEPOCH"))
        self.add_param(
            floatParameter("PX", units="mas", scale_to_internal=MAS_TO_RAD)
        )

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
        raise NotImplementedError

    def sky_basis(self, pdict):
        """(east, north) unit vectors at the reference position in ICRS
        xyz: the (I0, J0) basis of Kopeikin 1995 that DDK reads."""
        raise NotImplementedError

    def proper_motion(self, pdict):
        """(pm_long, pm_lat) in rad/s in this component's frame."""
        raise NotImplementedError

    def px_rad(self, pdict):
        """Parallax in radians (0.0 if unset)."""
        if self.params["PX"].value is None:
            return 0.0
        return pdict["PX"]

    def _pm_pair(self, pdict, lon, lat):
        pml, pmb = pdict.get(lon), pdict.get(lat)
        return (0.0 if pml is None else pml, 0.0 if pmb is None else pmb)

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


class AstrometryEquatorial(Astrometry):
    def __init__(self):
        super().__init__()
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

    def ssb_to_psr_xyz(self, pdict, bundle):
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

    def sky_basis(self, pdict):
        ra, dec = pdict["RAJ"], pdict["DECJ"]
        sr, cr = sin_p(ra), cos_p(ra)
        sd, cd = sin_p(dec), cos_p(dec)
        east = torch.stack([-sr, cr, torch.zeros_like(cr)], dim=-1)
        north = torch.stack([-cr * sd, -sr * sd, cd], dim=-1)
        return east, north

    def proper_motion(self, pdict):
        return self._pm_pair(pdict, "PMRA", "PMDEC")


class AstrometryEcliptic(Astrometry):
    """Ecliptic coordinates (ELONG, ELAT, PMELONG, PMELAT), rotated to
    equatorial by the IERS2010 mean obliquity at J2000, as NANOGrav
    models give their positions."""

    def __init__(self):
        super().__init__()
        self.add_param(
            AngleParameter("ELONG", units="deg", aliases=("LAMBDA",),
                           frozen=False)
        )
        self.add_param(
            AngleParameter("ELAT", units="deg", aliases=("BETA",),
                           frozen=False)
        )
        self.add_param(
            floatParameter("PMELONG", units="mas/yr",
                           scale_to_internal=_MAS_YR, aliases=("PMLAMBDA",))
        )
        self.add_param(
            floatParameter("PMELAT", units="mas/yr",
                           scale_to_internal=_MAS_YR, aliases=("PMBETA",))
        )
        self.add_param(strParameter("ECL", value="IERS2010"))

    def validate(self, model):
        self.require("ELONG", "ELAT")

    @staticmethod
    def _ecl_to_equ(v):
        # a static obliquity: rotated with host trigonometry
        ce, se = math.cos(OBL_J2000), math.sin(OBL_J2000)
        x = v[..., 0]
        y = ce * v[..., 1] - se * v[..., 2]
        z = se * v[..., 1] + ce * v[..., 2]
        return torch.stack([x, y, z], dim=-1)

    def ssb_to_psr_xyz(self, pdict, bundle):
        dt = self._dt_pos(pdict, bundle)
        lam0, bet0 = pdict["ELONG"], pdict["ELAT"]
        pml = pdict.get("PMELONG")
        pmb = pdict.get("PMELAT")
        bet = bet0 if pmb is None else bet0 + pmb * dt
        lam = lam0 if pml is None else lam0 + pml * dt / cos_p(bet0)
        cb = cos_p(bet)
        x_ecl = torch.stack(
            torch.broadcast_tensors(
                cos_p(lam) * cb, sin_p(lam) * cb, sin_p(bet)
            ),
            dim=-1,
        )
        return self._ecl_to_equ(x_ecl)

    def sky_basis(self, pdict):
        lam, bet = pdict["ELONG"], pdict["ELAT"]
        sl, cl = sin_p(lam), cos_p(lam)
        sb, cb = sin_p(bet), cos_p(bet)
        east = torch.stack([-sl, cl, torch.zeros_like(cl)], dim=-1)
        north = torch.stack([-cl * sb, -sl * sb, cb], dim=-1)
        return self._ecl_to_equ(east), self._ecl_to_equ(north)

    def proper_motion(self, pdict):
        return self._pm_pair(pdict, "PMELONG", "PMELAT")
