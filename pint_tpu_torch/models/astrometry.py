"""Astrometry: Roemer + parallax delays from sky position.

Counterpart of ``pint_tpu/models/astrometry.py`` (``Astrometry``,
``AstrometryEquatorial``, ``AstrometryEcliptic``): SSB->pulsar unit
vector with linear proper motion from POSEPOCH, Roemer delay -r_obs.n,
parallax delay px (|r|^2 - (r.n)^2) / (2 AU); and, for DDK, the sky
basis and proper motion in the component's own frame.  Internal units:
angles rad, proper motions rad/s, PX rad; positions arrive in
light-seconds, so the delays are plain f64 dot products.

The unit vector's sines and cosines are taken about the host's reference
angles (:func:`sincos_about`), and the dot products are sums in a fixed
order: the Roemer delay of a ~500 light-second orbit is then the same to
the last bit on the CUDA card and on the CPU.  Computed directly, the
card's sin/cos differ from the CPU's in the last bit, which moved the
Roemer delay by 2 ulps and the binary MSP's f64 step by 1.2e-7 sigma on
ELONG (PERF.md, PR 8).
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


def _sincos_about_raw(angle, ref, s0, c0):
    e = angle - ref
    se = torch.sin(e)
    cm1 = -2.0 * torch.square(torch.sin(0.5 * e))
    return s0 + (s0 * cm1 + c0 * se), c0 + (c0 * cm1 - s0 * se)


class _SinCosAbout(torch.autograd.Function):
    """:func:`sincos_about` with the derivative of sin and cos as its
    forward-mode rule: the design matrix's tangents then take two
    products, as those of torch.sin and torch.cos do, not one for each
    operation of the identities."""

    generate_vmap_rule = True

    @staticmethod
    def forward(angle, ref, s0, c0):
        return _sincos_about_raw(angle, ref, s0, c0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*output)

    @staticmethod
    def jvp(ctx, t_angle, _t_ref, _t_s0, _t_c0):
        s, c = ctx.saved_tensors
        return c * t_angle, -s * t_angle


def anchor_of(ref: float) -> tuple:
    """(ref, sin(ref), cos(ref)) on the host: what :func:`sincos_about`
    takes the angle about."""
    return float(ref), math.sin(ref), math.cos(ref)


def sincos_about(angle, ref):
    """(sin, cos) of ``angle`` (a tensor near the host float ``ref``) by
    the angle-addition identities about ``ref``: sin(ref) and cos(ref) on
    the host, and only the small offset e = angle - ref (exact, by
    Sterbenz) through the device's transcendentals, as sin(e) and
    cos(e) - 1 = -2 sin^2(e / 2).  A last-bit difference in those small
    terms is ~|e| ulps of the result, so every device that has IEEE f64
    adds and multiplies gets the same bits (but for a result within
    |e| ulps of a rounding boundary); the identities are exact for any
    e, so the accuracy is that of sin and cos.  ``ref`` may also be
    :func:`anchor_of`'s triple as device scalars (the parameter dict's
    anchors), which gives the same bits."""
    if not isinstance(ref, tuple):
        ref = anchor_of(ref)
    return _SinCosAbout.apply(angle, *ref)


def _dot3(a, b):
    """Sum over the last axis of a 3-vector product, in a fixed order."""
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


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
            day, sec = bundle.tdb_day[0], 0.0
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

    #: the angle parameters the unit vector is taken about
    _ANGLES = ()

    def anchors(self) -> dict:
        return {f"{n}:anchor": anchor_of(self.params[n].internal())
                for n in self._ANGLES}

    def _anchor(self, pdict, name):
        a = pdict.get(f"{name}:anchor")
        return a if a is not None else self.params[name].internal()

    def _pm_pair(self, pdict, lon, lat):
        pml, pmb = pdict.get(lon), pdict.get(lat)
        return (0.0 if pml is None else pml, 0.0 if pmb is None else pmb)

    def delay_term(self, pdict, bundle, acc_delay):
        n = self.ssb_to_psr_xyz(pdict, bundle)
        r = bundle.ssb_obs_pos_ls  # light-seconds
        rn = _dot3(r, n)
        roemer = -rn
        px = pdict.get("PX")
        if px is None:
            return roemer
        r2 = _dot3(r, r)
        plx = px / (2.0 * AU_LIGHT_SEC) * (r2 - rn * rn)
        return roemer + plx


class AstrometryEquatorial(Astrometry):
    register = True
    _ANGLES = ("RAJ", "DECJ")

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
        ra = ra0 if pmra is None else ra0 + pmra * dt / cos_p(dec0)
        sind, cosd = sincos_about(dec, self._anchor(pdict, "DECJ"))
        sina, cosa = sincos_about(ra, self._anchor(pdict, "RAJ"))
        return torch.stack(
            torch.broadcast_tensors(cosa * cosd, sina * cosd, sind),
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

    register = True
    _ANGLES = ("ELONG", "ELAT")

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
        sb, cb = sincos_about(bet, self._anchor(pdict, "ELAT"))
        sl, cl = sincos_about(lam, self._anchor(pdict, "ELONG"))
        x_ecl = torch.stack(
            torch.broadcast_tensors(cl * cb, sl * cb, sb), dim=-1)
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
