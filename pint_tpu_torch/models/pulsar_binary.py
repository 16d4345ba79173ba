"""Binary wrapper components: parameters -> the orbital delay kernels.

Counterpart of ``pint_tpu/models/pulsar_binary.py``: the ten binary
models (BT, BT_PIECEWISE, DD, DDS, DDH, DDGR, DDK, ELL1, ELL1H, ELL1K).
A wrapper owns the parameters (units, aliases, the tempo scaling of
PBDOT-like values) and marshals internal-unit values into the pure
kernels of ``models/binaries``; derivatives come from
``torch.func.jacfwd`` of the whole phase.

Internal units: seconds (PB, GAMMA, H3/H4), light-seconds (A1), radians
(OM), rad/s (OMDOT), dimensionless (ECC, EPS1/2, SINI, PBDOT).  The
binary is evaluated at t - (the delay of every component before it in
DEFAULT_ORDER): astrometry, Shapiro, DM, DMX and FD.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY, SECS_PER_JULIAN_YEAR, TSUN
from pint_tpu_torch.models.binaries import ell1 as _ell1
from pint_tpu_torch.models.binaries.bt import bt_delay
from pint_tpu_torch.models.binaries.dd import dd_delay, gr_pk_params
from pint_tpu_torch.models.binaries.orbits import (
    nb_fb,
    nb_pb,
    orbits_fb,
    orbits_pb,
    phase_from_orbits,
    to_f64,
)
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    boolParameter,
    floatParameter,
    prefix_index,
)
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.ops.scalarmath import cos_p, exp_p, sin_p
from pint_tpu_torch.toas.bundle import table_mjd

_DEG = math.pi / 180.0
_DEG_PER_YEAR = _DEG / SECS_PER_JULIAN_YEAR


class PulsarBinary(DelayComponent):
    """Base class: Keplerian and common post-Keplerian parameters."""

    category = "pulsar_system"
    binary_model_name: str = ""
    epoch_param = "T0"

    def __init__(self, max_fb: int = 12):
        super().__init__()
        self.add_param(floatParameter("PB", units="d", long_double=True,
                                      scale_to_internal=SECS_PER_DAY))
        self.add_param(floatParameter("PBDOT", units="s/s", unit_scale=True))
        self.add_param(floatParameter("XPBDOT", units="s/s",
                                      unit_scale=True))
        self.add_param(floatParameter("A1", units="ls", aliases=("X",)))
        self.add_param(floatParameter("A1DOT", units="ls/s",
                                      aliases=("XDOT",), unit_scale=True))
        self.add_param(MJDParameter("T0"))
        self.add_param(floatParameter("ECC", units="", aliases=("E",)))
        self.add_param(floatParameter("EDOT", units="1/s", unit_scale=True))
        self.add_param(floatParameter("OM", units="deg",
                                      scale_to_internal=_DEG))
        self.add_param(floatParameter("OMDOT", units="deg/yr",
                                      scale_to_internal=_DEG_PER_YEAR))
        self.add_param(floatParameter("M2", units="Msun"))
        self.add_param(floatParameter("SINI", units=""))
        self.add_param(floatParameter("GAMMA", units="s"))
        # FBn: the orbital-frequency series, the alternative to PB
        self.add_param(floatParameter("FB0", units="1/s", long_double=True,
                                      aliases=("FB",)))
        for k in range(1, max_fb + 1):
            self.add_param(floatParameter(f"FB{k}", units=f"1/s^{k + 1}"))

    def new_prefix_param(self, name):
        k = prefix_index(name, "FB")
        if k is None:
            return None
        return self.add_param(floatParameter(f"FB{k}", units=f"1/s^{k + 1}"))

    # -- shared marshalling ----------------------------------------------
    @staticmethod
    def val(pdict, name, default=0.0):
        v = pdict.get(name)
        return default if v is None else to_f64(v)

    def _use_fb(self):
        return self.params["FB0"].value is not None

    def _fb_list(self, pdict):
        out = [pdict["FB0"]]
        k = 1
        while (self.params.get(f"FB{k}") is not None
               and self.params[f"FB{k}"].value is not None):
            out.append(pdict[f"FB{k}"])
            k += 1
        return out

    def _dt(self, pdict, bundle, acc_delay) -> DD:
        day, sec = pdict[self.epoch_param]
        return bundle.dt_seconds(day, sec) - acc_delay

    def _orbits(self, pdict, dt: DD) -> DD:
        if self._use_fb():
            return orbits_fb(dt, self._fb_list(pdict))
        return orbits_pb(dt, pdict["PB"], self.val(pdict, "PBDOT"),
                         self.val(pdict, "XPBDOT"))

    def _nb(self, pdict, dt_f):
        if self._use_fb():
            return nb_fb(dt_f, self._fb_list(pdict))
        return nb_pb(dt_f, pdict["PB"], self.val(pdict, "PBDOT"),
                     self.val(pdict, "XPBDOT"))

    def _a1(self, pdict, dt_f):
        return self.val(pdict, "A1") + self.val(pdict, "A1DOT") * dt_f

    def _ecc(self, pdict, dt_f):
        return self.val(pdict, "ECC") + self.val(pdict, "EDOT") * dt_f

    def validate(self, model):
        if not self._use_fb():
            self.require("PB")
        self.require("A1", self.epoch_param)

    def delay_term(self, pdict, bundle, acc_delay):
        return self._binary_delay(pdict, bundle,
                                  self._dt(pdict, bundle, acc_delay))

    def _binary_delay(self, pdict, bundle, dt: DD):
        raise NotImplementedError


class BinaryBT(PulsarBinary):
    """Blandford & Teukolsky (1976)."""

    binary_model_name = "BT"

    def _om(self, pdict, dt_f):
        # BT: periastron advance linear in time
        return self.val(pdict, "OM") + self.val(pdict, "OMDOT") * dt_f

    def _binary_delay(self, pdict, bundle, dt: DD):
        dt_f = dt.to_float()
        M, _ = phase_from_orbits(self._orbits(pdict, dt))
        return bt_delay(M, self._nb(pdict, dt_f), self._a1(pdict, dt_f),
                        self._ecc(pdict, dt_f), self._om(pdict, dt_f),
                        self.val(pdict, "GAMMA"))


class BinaryBTPiecewise(BinaryBT):
    """BT with piecewise T0 / A1 (T0X_####, A1X_####) over MJD ranges
    XR1_#### <= MJD < XR2_####; the ranges become 0/1 mask columns
    ``BTX_####`` at compile time."""

    binary_model_name = "BT_PIECEWISE"
    _PIECE = ("T0X_", "A1X_", "XR1_", "XR2_")

    def __init__(self):
        super().__init__()
        self.piece_indices: list[int] = []

    def add_piece(self, idx: int):
        self.add_param(MJDParameter(f"T0X_{idx:04d}"))
        self.add_param(floatParameter(f"A1X_{idx:04d}", units="ls"))
        self.add_param(floatParameter(f"XR1_{idx:04d}", units="MJD"))
        self.add_param(floatParameter(f"XR2_{idx:04d}", units="MJD"))
        self.piece_indices.append(idx)

    def new_prefix_param(self, name):
        for pref in self._PIECE:
            idx = prefix_index(name, pref)
            if idx is not None:
                if f"XR1_{idx:04d}" not in self.params:
                    self.add_piece(idx)
                return self.params[f"{pref}{idx:04d}"]
        return super().new_prefix_param(name)

    def setup(self, model):
        # a piece exists if any of its parameters is set, so validate
        # catches a missing range bound
        idx = set()
        for n, p in self.params.items():
            if p.value is None:
                continue
            for pref in self._PIECE:
                if n.startswith(pref) and n[len(pref):].isdigit():
                    idx.add(int(n[len(pref):]))
        self.piece_indices = sorted(idx)

    def validate(self, model):
        super().validate(model)
        spans = []
        for i in self.piece_indices:
            r1 = self.params[f"XR1_{i:04d}"].value
            r2 = self.params[f"XR2_{i:04d}"].value
            if r1 is None or r2 is None:
                raise ValueError(f"BT piecewise range {i} misses XR1/XR2")
            spans.append((r1, r2, i))
        spans.sort()
        for (a1, a2, i), (b1, b2, j) in zip(spans, spans[1:]):
            if b1 < a2:
                raise ValueError(f"BT piecewise ranges {i} and {j} overlap")

    def basis_keys(self) -> list[str]:
        return [f"BTX_{i:04d}" for i in self.piece_indices]

    def extra_masks(self, toas) -> dict:
        mjd = table_mjd(toas)
        out = {}
        for i in self.piece_indices:
            r1 = self.params[f"XR1_{i:04d}"].value
            r2 = self.params[f"XR2_{i:04d}"].value
            out[f"BTX_{i:04d}"] = ((mjd >= r1) & (mjd < r2)).astype(
                np.float64)
        return out

    def _binary_delay(self, pdict, bundle, dt: DD):
        # piecewise T0: (T0X - T0) seconds off dt inside each range
        t0_day, t0_sec = pdict["T0"]
        shift = torch.zeros(bundle.ntoa, dtype=dt.hi.dtype,
                            device=dt.hi.device)
        a1_extra = torch.zeros_like(shift)
        for i in self.piece_indices:
            m = bundle.masks[f"BTX_{i:04d}"]
            t0x = pdict.get(f"T0X_{i:04d}")
            if t0x is not None:
                xd, xs = t0x
                shift = shift + m * ((xd - t0_day) * 86400.0
                                     + (xs - t0_sec).to_float())
            a1x = pdict.get(f"A1X_{i:04d}")
            if a1x is not None:
                a1_extra = a1_extra + m * (a1x - self.val(pdict, "A1"))
        dt = dt - shift
        dt_f = dt.to_float()
        M, _ = phase_from_orbits(self._orbits(pdict, dt))
        return bt_delay(M, self._nb(pdict, dt_f),
                        self._a1(pdict, dt_f) + a1_extra,
                        self._ecc(pdict, dt_f), self._om(pdict, dt_f),
                        self.val(pdict, "GAMMA"))


class BinaryDD(PulsarBinary):
    """Damour & Deruelle (1986)."""

    binary_model_name = "DD"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("DR", units=""))
        self.add_param(floatParameter("DTH", units="", aliases=("DTHETA",)))
        self.add_param(floatParameter("A0", units="s"))
        self.add_param(floatParameter("B0", units="s"))

    def _nb0(self, pdict):
        """The orbital angular frequency n (rad/s) of k = OMDOT / n."""
        if self._use_fb():
            return 2.0 * math.pi * to_f64(pdict["FB0"])
        return 2.0 * math.pi / to_f64(pdict["PB"])

    def _pk(self, pdict, dt_f):
        """Post-Keplerian ingredients (DDS, DDH, DDGR override)."""
        return {
            "k": self.val(pdict, "OMDOT") / self._nb0(pdict),
            "gamma": self.val(pdict, "GAMMA"),
            "m2r": TSUN * self.val(pdict, "M2"),
            "sini": self.val(pdict, "SINI"),
            "dr": self.val(pdict, "DR"),
            "dth": self.val(pdict, "DTH"),
        }

    def _dd(self, pdict, dt, a1, om, sini_over=None):
        dt_f = dt.to_float()
        M, norb = phase_from_orbits(self._orbits(pdict, dt))
        pk = self._pk(pdict, dt_f)
        return dd_delay(
            M, norb, self._nb(pdict, dt_f), a1, self._ecc(pdict, dt_f), om,
            pk["k"], gamma=pk["gamma"], m2r=pk["m2r"],
            sini=pk["sini"] if sini_over is None else sini_over,
            dr=pk["dr"], dth=pk["dth"], a0=self.val(pdict, "A0"),
            b0=self.val(pdict, "B0"),
        )

    def _binary_delay(self, pdict, bundle, dt: DD):
        return self._dd(pdict, dt, self._a1(pdict, dt.to_float()),
                        self.val(pdict, "OM"))


class BinaryDDH(BinaryDD):
    """DD with the orthometric Shapiro parameters (H3, STIGMA) of Freire
    & Wex 2010: r = H3 / STIGMA^3, s = 2 STIGMA / (1 + STIGMA^2)."""

    binary_model_name = "DDH"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("H3", units="s"))
        self.add_param(floatParameter("STIGMA", units="",
                                      aliases=("STIG", "VARSIGMA")))
        for n in ("M2", "SINI"):
            self.remove_param(n)

    def validate(self, model):
        super().validate(model)
        self.require("H3", "STIGMA")
        stig = float(self.params["STIGMA"].value)
        if not 0.0 < stig < 1.0:
            raise ValueError(f"DDH needs 0 < STIGMA < 1 (got {stig})")

    def _pk(self, pdict, dt_f):
        pk = super()._pk(pdict, dt_f)
        h3 = self.val(pdict, "H3")
        stig = self.val(pdict, "STIGMA")
        pk["m2r"] = h3 / (stig * stig * stig)
        pk["sini"] = 2.0 * stig / (1.0 + stig * stig)
        return pk


class BinaryDDS(BinaryDD):
    """DD with the SHAPMAX form of the Shapiro shape, s = 1 -
    exp(-SHAPMAX)."""

    binary_model_name = "DDS"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("SHAPMAX", units=""))
        self.remove_param("SINI")

    def _pk(self, pdict, dt_f):
        pk = super()._pk(pdict, dt_f)
        pk["sini"] = 1.0 - exp_p(-self.val(pdict, "SHAPMAX"))
        return pk


class BinaryDDGR(BinaryDD):
    """DD with every post-Keplerian parameter fixed by GR from (MTOT,
    M2); XOMDOT and XPBDOT are excesses beyond GR."""

    binary_model_name = "DDGR"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("MTOT", units="Msun"))
        self.add_param(floatParameter("XOMDOT", units="deg/yr",
                                      scale_to_internal=_DEG_PER_YEAR))
        for n in ("SINI", "GAMMA", "OMDOT", "PBDOT", "DR", "DTH"):
            self.remove_param(n)

    def validate(self, model):
        super().validate(model)
        self.require("MTOT", "M2")

    def _gr(self, pdict, dt_f):
        pb = pdict.get("PB")
        pb_s = 1.0 / to_f64(pdict["FB0"]) if pb is None else to_f64(pb)
        return gr_pk_params(pb_s, self._ecc(pdict, dt_f),
                            self.val(pdict, "A1"),
                            TSUN * self.val(pdict, "MTOT"),
                            TSUN * self.val(pdict, "M2"))

    def _orbits(self, pdict, dt: DD):
        # PBDOT is the GR value (plus any XPBDOT)
        if self._use_fb():
            return orbits_fb(dt, self._fb_list(pdict))
        return orbits_pb(dt, pdict["PB"], self._gr(pdict, 0.0)["pbdot"],
                         self.val(pdict, "XPBDOT"))

    def _nb(self, pdict, dt_f):
        gr = self._gr(pdict, 0.0)
        if self._use_fb():
            return nb_fb(dt_f, self._fb_list(pdict))
        return nb_pb(dt_f, pdict["PB"], gr["pbdot"],
                     self.val(pdict, "XPBDOT"))

    def _pk(self, pdict, dt_f):
        gr = self._gr(pdict, dt_f)
        return {
            "k": gr["k"] + self.val(pdict, "XOMDOT") / self._nb0(pdict),
            "gamma": gr["gamma"],
            "m2r": TSUN * self.val(pdict, "M2"),
            "sini": gr["sini"],
            "dr": gr["dr"],
            "dth": gr["dth"],
        }


class BinaryDDK(BinaryDD):
    """DD with the Kopeikin (1995, 1996) couplings to astrometry: KIN and
    KOM orient the orbit on the sky, proper motion drifts the apparent
    inclination and periastron, and the observer's offset from the SSB
    adds annual terms scaled by 1/distance (needs PX).  The astrometry
    component is found in ``setup(model)``."""

    binary_model_name = "DDK"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("KIN", units="deg",
                                      scale_to_internal=_DEG))
        self.add_param(floatParameter("KOM", units="deg",
                                      scale_to_internal=_DEG))
        self.add_param(boolParameter("K96", value=True))
        self.remove_param("SINI")
        self._astrometry_ref = None

    def setup(self, model):
        from pint_tpu_torch.models.astrometry import Astrometry

        self._astrometry_ref = None
        for c in model.components.values():
            if isinstance(c, Astrometry):
                self._astrometry_ref = c

    def validate(self, model):
        super().validate(model)
        self.require("KIN", "KOM")
        if self._astrometry_ref is None:
            raise ValueError("DDK requires an astrometry component")

    def _kopeikin(self, pdict, bundle, dt_f):
        """-> (a1_eff, om_eff, kin) per TOA."""
        from pint_tpu_torch.constants import AU_LIGHT_SEC

        ast = self._astrometry_ref
        kin0, kom = pdict["KIN"], pdict["KOM"]
        sk, ck = sin_p(kom), cos_p(kom)
        sin_kin0 = sin_p(kin0)
        cot_kin0 = cos_p(kin0) / sin_kin0
        pml, pmb = ast.proper_motion(pdict)
        # Kopeikin 1996: secular drift from proper motion
        dkin_pm = (-pml * sk + pmb * ck) * dt_f
        dom_pm = (pml * ck + pmb * sk) / sin_kin0 * dt_f
        a1 = self._a1(pdict, dt_f)
        a1_eff = a1 * (1.0 + cot_kin0 * dkin_pm)
        om_eff = self.val(pdict, "OM") + dom_pm
        kin = kin0 + dkin_pm
        # Kopeikin 1995: annual orbital parallax (K96)
        px = ast.px_rad(pdict)
        if self.params["K96"].value and ast.params["PX"].value is not None:
            d_ls = AU_LIGHT_SEC / px
            east, north = ast.sky_basis(pdict)
            r = bundle.ssb_obs_pos_ls
            delta_i0 = torch.sum(r * east, dim=-1)
            delta_j0 = torch.sum(r * north, dim=-1)
            a1_eff = a1_eff + a1 / d_ls * cot_kin0 * (
                delta_i0 * sk - delta_j0 * ck)
            om_eff = om_eff - (delta_i0 * ck + delta_j0 * sk) / (
                d_ls * sin_kin0)
        return a1_eff, om_eff, kin

    def _binary_delay(self, pdict, bundle, dt: DD):
        a1_eff, om_eff, kin = self._kopeikin(pdict, bundle, dt.to_float())
        return self._dd(pdict, dt, a1_eff, om_eff,
                        sini_over=torch.sin(kin))


class BinaryELL1(PulsarBinary):
    """Lange et al. 2001 small-eccentricity model."""

    binary_model_name = "ELL1"
    epoch_param = "TASC"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("TASC"))
        self.add_param(floatParameter("EPS1", units=""))
        self.add_param(floatParameter("EPS2", units=""))
        self.add_param(floatParameter("EPS1DOT", units="1/s",
                                      unit_scale=True))
        self.add_param(floatParameter("EPS2DOT", units="1/s",
                                      unit_scale=True))
        # ELL1 does not use T0/ECC/OM directly
        for n in ("T0", "ECC", "EDOT", "OM", "OMDOT", "GAMMA"):
            self.remove_param(n)

    def validate(self, model):
        super().validate(model)
        self.require("EPS1", "EPS2")

    def _eps(self, pdict, dt_f):
        return _ell1.eps_at_t(
            dt_f, self.val(pdict, "EPS1"), self.val(pdict, "EPS2"),
            self.val(pdict, "EPS1DOT"), self.val(pdict, "EPS2DOT"))

    def _shapiro(self, pdict, phi):
        if (self.params["M2"].value is not None
                and self.params["SINI"].value is not None):
            return _ell1.shapiro_ms(phi, TSUN * self.val(pdict, "M2"),
                                    self.val(pdict, "SINI"))
        return 0.0

    def _binary_delay(self, pdict, bundle, dt: DD):
        dt_f = dt.to_float()
        phi, _ = phase_from_orbits(self._orbits(pdict, dt))
        nb = self._nb(pdict, dt_f)
        eps1, eps2 = self._eps(pdict, dt_f)
        dre, drep, drepp = _ell1.roemer_terms(phi, self._a1(pdict, dt_f),
                                              eps1, eps2)
        d = _ell1.inverse_timing(dre, drep, drepp, nb)
        return d + self._shapiro(pdict, phi)


class BinaryELL1H(BinaryELL1):
    """ELL1 with the orthometric Shapiro parameters (Freire & Wex 2010)."""

    binary_model_name = "ELL1H"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("H3", units="s"))
        self.add_param(floatParameter("H4", units="s"))
        self.add_param(floatParameter("STIGMA", units="",
                                      aliases=("STIG", "VARSIGMA")))
        self.add_param(floatParameter("NHARM", units=""))
        for n in ("M2", "SINI"):
            self.remove_param(n)

    def validate(self, model):
        super().validate(model)
        self.require("H3")

    def _shapiro(self, pdict, phi):
        h3 = self.val(pdict, "H3")
        if self.params["STIGMA"].value is not None:
            return _ell1.shapiro_h3_stig(phi, h3, self.val(pdict, "STIGMA"))
        if self.params["H4"].value is not None:
            return _ell1.shapiro_h3_stig(phi, h3, self.val(pdict, "H4") / h3)
        return _ell1.shapiro_h3_only(phi, h3)


class BinaryELL1k(BinaryELL1):
    """ELL1 with an explicit OMDOT and LNEDOT (Susobhanan et al. 2018)."""

    binary_model_name = "ELL1K"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("OMDOT", units="deg/yr",
                                      scale_to_internal=_DEG_PER_YEAR))
        self.add_param(floatParameter("LNEDOT", units="1/s",
                                      unit_scale=True))
        for n in ("EPS1DOT", "EPS2DOT"):
            self.remove_param(n)

    def _eps(self, pdict, dt_f):
        return _ell1.eps_at_t_k(
            dt_f, self.val(pdict, "EPS1"), self.val(pdict, "EPS2"),
            self.val(pdict, "OMDOT"), self.val(pdict, "LNEDOT"))


#: the ten binary models by the name of their BINARY par line
BINARY_MODELS = {
    cls.binary_model_name: cls
    for cls in (BinaryBT, BinaryBTPiecewise, BinaryDD, BinaryDDS, BinaryDDH,
                BinaryDDGR, BinaryDDK, BinaryELL1, BinaryELL1H, BinaryELL1k)
}
