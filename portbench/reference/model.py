"""Plain reference of the benchmark's timing models, in numpy.

The model is the one the configurations write: an ELL1 binary
millisecond pulsar with ecliptic astrometry (proper motion, parallax),
the Sun's Shapiro delay, DM with DMX ranges, FD terms, a phase JUMP,
F0/F1 spindown, EFAC/EQUAD white noise, ECORR and power-law red noise.
It follows the published formulas directly and shares no code with the
program under test:

- delays, in the order each sees the earlier ones: Roemer and parallax
  (-r.n + PX (|r|^2 - (r.n)^2) / 2 AU, n rotated from ecliptic by the
  IERS2010 obliquity), the Sun's Shapiro delay (-2 GM/c^3 ln((r - r.n) /
  AU)), dispersion (K (DM + DMX) / f^2 with K = 1 / 2.41e-4 s MHz^2),
  FD (sum FDk ln(f / 1 GHz)^k) and the ELL1 orbit (Lange et al. 2001:
  Roemer delay to first order in eccentricity, the inverse-timing
  correction and the Shapiro delay in M2, SINI) at the time less those
  delays;
- the spin phase F0 dt + F1 dt^2 / 2 in double-double, dt the TDB time
  from PEPOCH less the delay, minus JUMP F0 on the jumped TOAs; the
  residual is the phase to the nearest pulse over F0 + F1 (t - PEPOCH);
- the design matrix d(residual)/d(parameter), with a leading offset
  column: spin and jump columns in closed form, the delay parameters by
  complex-step differentiation of the delay chain (exact to rounding),
  the linear DMX and FD columns through the orbit's rate d(delay)/dt;
- the noise: sigma = EFAC sqrt(err^2 + EQUAD^2), ECORR over observing
  epochs (a gap over 10 s starts a new one), and 2 x TNREDC sin/cos
  harmonics of the data span weighted by A^2 / (12 pi^2) f_yr^(gamma-3)
  f^-gamma / T.

Internal units, as the program's parameters use them: angles in rad,
proper motions in rad/s, PX in rad, PB and epochs in seconds, A1 in
light-seconds, EQUAD and ECORR in seconds.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

from portbench.reference.dd import DD, epoch_seconds
from portbench.reference.parfile import read_par

C = 299792458.0
AU_LIGHT_SEC = 149597870700.0 / C
SECS_PER_DAY = 86400.0
SECS_PER_JULIAN_YEAR = 86400.0 * 365.25
DEG = math.pi / 180.0
MAS = math.pi / (180.0 * 3600.0) * 1e-3
OBLIQUITY = 84381.406 * math.pi / (180.0 * 3600.0)
GM_SUN = 1.32712440041279419e20
TSUN = GM_SUN / C**3
DM_K = 1.0 / 2.41e-4
F_YR = 1.0 / SECS_PER_JULIAN_YEAR
ECORR_GAP_S = 10.0

#: par unit -> internal unit factors of the float parameters
_SCALE = {"ELONG": DEG, "ELAT": DEG, "PX": MAS,
          "PMELONG": MAS / SECS_PER_JULIAN_YEAR,
          "PMELAT": MAS / SECS_PER_JULIAN_YEAR}
_MICRO = ("EQUAD", "ECORR")
#: epochs, held as (day, seconds)
_EPOCHS = ("TASC", "PEPOCH", "POSEPOCH")
#: parameters the delay chain takes, differentiated by complex step
DELAY_PARAMS = ("ELONG", "ELAT", "PMELONG", "PMELAT", "PX", "PB", "A1",
                "TASC", "EPS1", "EPS2", "M2", "SINI")


def internal_value(name: str, q: Fraction):
    """A par value (exact) in internal units: float, DD or (day, DD)."""
    if name in _EPOCHS:
        day = math.floor(q)
        return day, DD.from_fraction((q - day) * 86400)
    if name == "PB":
        return DD.from_fraction(q * 86400)
    if name == "F0":
        return DD.from_fraction(q)
    base = name.rstrip("0123456789")
    if base in _MICRO:
        return float(q) * 1e-6
    return float(q) * _SCALE.get(name, 1.0)


def quantize_epochs(mjd, select):
    """(n, n_epoch) 0/1 matrix of the selected TOAs grouped into observing
    epochs: a gap of more than ECORR_GAP_S starts a new epoch."""
    idx = np.flatnonzero(select)
    if idx.size == 0:
        return np.zeros((len(mjd), 0))
    order = idx[np.argsort(mjd[idx], kind="stable")]
    gaps = np.diff(mjd[order]) * SECS_PER_DAY > ECORR_GAP_S
    epoch = np.concatenate([[0], np.cumsum(gaps)])
    U = np.zeros((len(mjd), int(epoch[-1]) + 1))
    U[order, epoch] = 1.0
    return U


class ReferenceModel:
    """The reference timing model of ``par_text`` against a TOA table
    (the host dict the benchmark makes: ``tdb_day``, ``tdb_sec_hi``,
    ``tdb_sec_lo``, ``freq_mhz``, ``error_us``, ``flags``,
    ``ssb_obs_pos_ls``, ``obs_sun_pos_ls``).  ``x`` is always the vector
    of deltas from the par values in internal units, in ``free`` order."""

    def __init__(self, par_text: str, table: dict):
        par = read_par(par_text)
        if par.strings.get("BINARY") != "ELL1":
            raise ValueError("the reference models the ELL1 binary only")
        self.free = list(par.free)
        self.start = {n: internal_value(n, q) for n, q in par.values.items()}
        self.masks = par.masks
        self.n = len(table["freq_mhz"])
        self.day = np.asarray(table["tdb_day"], np.float64)
        self.sec = DD(np.asarray(table["tdb_sec_hi"], np.float64),
                      np.asarray(table["tdb_sec_lo"], np.float64))
        self.mjd = self.day + self.sec.to_float() / SECS_PER_DAY
        self.freq = np.asarray(table["freq_mhz"], np.float64)
        self.err_s = np.asarray(table["error_us"], np.float64) * 1e-6
        zeros = np.zeros((self.n, 3))
        self.pos = np.asarray(table.get("ssb_obs_pos_ls", zeros), np.float64)
        self.sun = np.asarray(table.get("obs_sun_pos_ls", zeros), np.float64)
        self.flags = table["flags"]
        s = self.start
        self.dt_pos = epoch_seconds(self.day, self.sec,
                                    *s["POSEPOCH"]).to_float()
        self.dt_pep = epoch_seconds(self.day, self.sec, *s["PEPOCH"])
        self.dt_tasc = epoch_seconds(self.day, self.sec, *s["TASC"])
        self.dmx = sorted(n for n in s if n.startswith("DMX_"))
        self.dmx_matrix = np.stack(
            [((self.mjd >= float(par.values[f"DMXR1_{n[4:]}"]))
              & (self.mjd <= float(par.values[f"DMXR2_{n[4:]}"])))
             for n in self.dmx], axis=1).astype(np.float64)
        self.fd = sorted((n for n in s if n.startswith("FD")
                          and n[2:].isdigit()), key=lambda n: int(n[2:]))
        self.logf = np.log(self.freq / 1000.0)
        self._mask_cache = {}

    # -- parameters ------------------------------------------------------
    def mask(self, name):
        if name not in self._mask_cache:
            key, val = self.masks[name]
            self._mask_cache[name] = np.array(
                [f.get(key) == val for f in self.flags], dtype=np.float64)
        return self._mask_cache[name]

    def _family(self, fam):
        return [n for n in self.masks if n.rstrip("0123456789") == fam]

    def values(self, x):
        """Parameter values at x: float parameters as float64 (or complex,
        when x is), F0 and PB as DD, TASC as its delta in seconds."""
        v = {n: q for n, q in self.start.items()
             if not isinstance(q, (DD, tuple))}
        v["F0"], v["PB"], v["TASC"] = self.start["F0"], self.start["PB"], 0.0
        for i, n in enumerate(self.free):
            v[n] = v[n] + x[i]
        return v

    # -- delays ----------------------------------------------------------
    def _astrometry(self, v):
        """(Roemer + parallax delay, the Sun's Shapiro delay)."""
        bet = v["ELAT"] + v["PMELAT"] * self.dt_pos
        lam = v["ELONG"] + v["PMELONG"] * self.dt_pos / np.cos(v["ELAT"])
        cb = np.cos(bet)
        ne = (np.cos(lam) * cb, np.sin(lam) * cb, np.sin(bet))
        ce, se = math.cos(OBLIQUITY), math.sin(OBLIQUITY)
        nx, ny, nz = ne[0], ce * ne[1] - se * ne[2], se * ne[1] + ce * ne[2]
        p = self.pos
        rn = p[:, 0] * nx + p[:, 1] * ny + p[:, 2] * nz
        r2 = np.sum(p * p, axis=1)
        geo = -rn + v["PX"] / (2.0 * AU_LIGHT_SEC) * (r2 - rn * rn)
        s = self.sun
        rs = np.sqrt(np.sum(s * s, axis=1))
        rsn = s[:, 0] * nx + s[:, 1] * ny + s[:, 2] * nz
        arg = np.where(rs > 0, (rs - rsn) / AU_LIGHT_SEC, 1.0)
        shapiro = np.where(rs > 0, -2.0 * TSUN * np.log(arg), 0.0)
        return geo + shapiro

    def _dispersion_fd(self, v):
        dm = v["DM"] + self.dmx_matrix @ np.array([v[n] for n in self.dmx])
        fd = sum(v[n] * self.logf ** int(n[2:]) for n in self.fd)
        return DM_K * dm / np.square(self.freq) + fd

    def _binary(self, v, dt_b):
        """ELL1 delay at the binary time dt_b (seconds from TASC): a DD
        on the value path (the orbit count in double-double), a complex
        array on the derivative path."""
        if isinstance(dt_b, DD):
            _, frac = (dt_b / v["PB"]).nearest_frac()
            pb = v["PB"].to_float()
        else:
            pb = v["PB"] if not isinstance(v["PB"], DD) else v["PB"].to_float()
            orbits = dt_b / pb
            frac = orbits - np.floor(orbits.real + 0.5)
        phi = 2.0 * math.pi * frac
        nb = 2.0 * math.pi / pb
        a1, e1, e2 = v["A1"], v["EPS1"], v["EPS2"]
        s, c = np.sin(phi), np.cos(phi)
        s2, c2 = np.sin(2.0 * phi), np.cos(2.0 * phi)
        dre = a1 * (s + 0.5 * (e2 * s2 - e1 * c2))
        drep = a1 * (c + e2 * c2 + e1 * s2)
        drepp = a1 * (-s + 2.0 * (e1 * c2 - e2 * s2))
        nd = nb * drep
        roemer = dre * (1.0 - nd + nd * nd + 0.5 * nb * nb * dre * drepp)
        shapiro = -2.0 * TSUN * v["M2"] * np.log(1.0 - v["SINI"] * s)
        return roemer + shapiro

    def delay(self, v):
        """Total delay (float64) at parameter values v."""
        acc = self._astrometry(v) + self._dispersion_fd(v)
        return acc + self._binary(v, self.dt_tasc - v["TASC"] - acc)

    def _complex_delay(self, v, disp):
        """The delay chain at complex values v of the parameters before
        and in the orbit; ``disp``, the dispersion and FD delay, takes no
        complex parameter."""
        acc = self._astrometry(v) + disp
        dt_b = self.dt_tasc.to_float() - v["TASC"] - acc
        return acc + self._binary(v, dt_b)

    # -- phase and residuals ----------------------------------------------
    def _spin(self, v, delay):
        """(phase DD, dt from PEPOCH less the delay as float64)."""
        dt = self.dt_pep - delay
        f0 = v["F0"]
        ph = dt * (f0 + dt * (0.5 * v["F1"]))
        jump = sum(v[n] * self.mask(n) for n in self._family("JUMP"))
        return ph - jump * f0.to_float(), dt.to_float()

    def spin_frequency(self, v):
        return v["F0"].to_float() + v["F1"] * self.dt_pep.to_float()

    def residuals(self, x):
        """Time residuals (s) to the nearest pulse, no mean removed."""
        v = self.values(x)
        ph, _ = self._spin(v, self.delay(v))
        return ph.nearest_frac()[1] / self.spin_frequency(v)

    def design(self, x):
        """(n, 1 + nfree) design matrix: the offset column, then
        d(residual)/d(x_i) in seconds per internal unit."""
        v = self.values(x)
        delay = self.delay(v)
        _, dt = self._spin(v, delay)
        f0 = v["F0"].to_float()
        f_inst = f0 + v["F1"] * dt
        scale = -f_inst / self.spin_frequency(v)
        h = 1e-30
        # the orbit's rate: how a delay before the binary moves its delay
        vc = {k: (val if isinstance(val, DD) else complex(val))
              for k, val in v.items()}
        disp = self._dispersion_fd(v)
        acc = self._astrometry(v) + disp
        dt_b = self.dt_tasc.to_float() - v["TASC"] - acc
        rate = self._binary(vc, dt_b + 1j * h).imag / h
        chain = scale * (1.0 - rate)
        jump = sum(v[n] * self.mask(n) for n in self._family("JUMP"))
        cols = [np.ones(self.n)]
        for name in self.free:
            if name in DELAY_PARAMS:
                vp = dict(vc)
                if name == "PB":
                    vp["PB"] = v["PB"].to_float() + 1j * h
                else:
                    vp[name] = vp[name] + 1j * h
                col = scale * self._complex_delay(vp, disp).imag / h
            elif name.startswith("DMX_"):
                col = chain * DM_K * self.dmx_matrix[:, self.dmx.index(name)] \
                    / np.square(self.freq)
            elif name.startswith("FD"):
                col = chain * self.logf ** int(name[2:])
            elif name == "F0":
                col = (dt - jump) / self.spin_frequency(v)
            elif name == "F1":
                col = 0.5 * dt * dt / self.spin_frequency(v)
            elif name.startswith("JUMP"):
                col = -self.mask(name) * f0 / self.spin_frequency(v)
            else:
                raise ValueError(f"the reference does not fit {name}")
            cols.append(np.real(col))
        return np.stack(cols, axis=1)

    # -- noise -------------------------------------------------------------
    def sigma(self):
        """Scaled white sigma (s): EFAC sqrt(err^2 + EQUAD^2)."""
        equad2 = sum(self.start[n] ** 2 * self.mask(n)
                     for n in self._family("EQUAD"))
        efac = np.ones(self.n)
        for n in self._family("EFAC"):
            efac = efac * (1.0 + (self.start[n] - 1.0) * self.mask(n))
        return efac * np.sqrt(self.err_s ** 2 + equad2)

    def red_basis(self):
        """(T (n, 2 nharm) [sin | cos], phi (2 nharm,)) of the power-law
        red noise over the data span."""
        nh = int(self.start["TNREDC"])
        t = (self.day - self.day[0]) * SECS_PER_DAY + self.sec.to_float()
        tspan = t.max() - t.min()
        f = np.arange(1, nh + 1) / tspan
        arg = 2.0 * math.pi * t[:, None] * f[None, :]
        T = np.concatenate([np.sin(arg), np.cos(arg)], axis=1)
        amp2 = 10.0 ** (2.0 * self.start["TNREDAMP"])
        phi = amp2 / (12.0 * math.pi ** 2) * F_YR ** -3 \
            * (f / F_YR) ** (-self.start["TNREDGAM"]) / tspan
        return T, np.maximum(np.concatenate([phi, phi]), 1e-30)

    def ecorr_basis(self):
        """(U (n, n_epoch), weights ECORR^2) over every ECORR selection."""
        Us, ws = [], []
        for n in self._family("ECORR"):
            U = quantize_epochs(self.mjd, self.mask(n) > 0)
            Us.append(U)
            ws.append(np.full(U.shape[1], self.start[n] ** 2))
        if not Us:
            return np.zeros((self.n, 0)), np.zeros(0)
        return np.concatenate(Us, axis=1), np.concatenate(ws)

    def noise(self):
        """(sigma (n,), T (n, k), phi (k,)): C = diag(sigma^2) + T phi T^T."""
        Tr, pr = self.red_basis() if "TNREDAMP" in self.start else (
            np.zeros((self.n, 0)), np.zeros(0))
        Te, pe = self.ecorr_basis()
        return (self.sigma(), np.concatenate([Te, Tr], axis=1),
                np.concatenate([pe, pr]))
