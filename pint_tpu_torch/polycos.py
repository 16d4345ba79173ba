"""Polycos: piecewise-polynomial phase predictors (tempo format).

Counterpart of ``pint_tpu/polycos.py`` (reference parity:
src/pint/polycos.py::Polycos / PolycoEntry): per-segment polynomial fits
of the model phase for online folding, evaluation of the absolute phase
and spin frequency, and the tempo polyco.dat format:

  phase(t) = RPHASE + 60 DT F0 + C1 + C2 DT + C3 DT^2 + ...
  f(t)     = F0 + (1/60) (C2 + 2 C3 DT + ...)         [Hz]
  DT       = (t - TMID) minutes

Generation ingests the Chebyshev nodes of every segment as one TOA set
and evaluates the compiled model's absolute phase at all of them in one
call on ``device`` (None: the CUDA card); the coefficient fits are small
host least-squares problems.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs


@dataclass
class PolycoEntry:
    tmid_mjd: float  # midpoint, UTC MJD
    mjd_span_minutes: float
    rphase_int: float  # integer part of reference phase
    rphase_frac: float
    f0: float  # reference spin frequency (Hz)
    obs: str
    obsfreq_mhz: float
    coeffs: np.ndarray = field(default_factory=lambda: np.zeros(12))
    psrname: str = ""
    dm: float = 0.0

    def dt_minutes(self, mjd):
        return (np.asarray(mjd, dtype=np.float64) - self.tmid_mjd) * 1440.0

    def abs_phase(self, mjd):
        """(int, frac) absolute phase at UTC mjd (float array)."""
        dt = self.dt_minutes(mjd)
        poly = np.polynomial.polynomial.polyval(dt, self.coeffs)
        spin = 60.0 * dt * self.f0
        total_frac = self.rphase_frac + poly + spin
        carry = np.floor(total_frac)
        return self.rphase_int + carry, total_frac - carry

    def spin_freq(self, mjd):
        dt = self.dt_minutes(mjd)
        dcoef = np.polynomial.polynomial.polyder(self.coeffs)
        return self.f0 + np.polynomial.polynomial.polyval(dt, dcoef) / 60.0


class Polycos:
    def __init__(self, entries: list[PolycoEntry]):
        self.entries = entries

    # -- generation -------------------------------------------------------
    @classmethod
    def generate(
        cls,
        model,
        start_mjd: float,
        end_mjd: float,
        obs: str = "@",
        segment_minutes: float = 60.0,
        ncoeff: int = 12,
        obsfreq_mhz: float = 1400.0,
        *,
        device=None,
    ) -> "Polycos":
        from pint_tpu_torch.toas.ingest import ingest_for_model

        span_days = segment_minutes / 1440.0
        nseg = max(1, int(np.ceil((end_mjd - start_mjd) / span_days)))
        nodes_per_seg = 2 * ncoeff + 1
        # Chebyshev nodes in each segment, all evaluated in one pass
        u = np.cos(np.pi * (np.arange(nodes_per_seg) + 0.5) / nodes_per_seg)
        mjds = []
        tmids = []
        for s in range(nseg):
            t0 = start_mjd + s * span_days
            # snap TMID to the tempo format's 11-decimal grid: an
            # arbitrary fraction would lose ~1e-11 day in write/read,
            # which the 60*DT*F0 ramp turns into ~3e-4 cycles of
            # roundtrip phase error
            tmid = round(t0 + span_days / 2.0, 11)
            tmids.append(tmid)
            mjds.append(tmid + u * span_days / 2.0)
        mjds = np.concatenate(mjds)
        n = len(mjds)
        toas = TOAs(
            TimeArray.from_mjd_float(mjds, scale="utc"),
            np.full(n, obsfreq_mhz), np.ones(n), [obs] * n,
            [dict() for _ in range(n)],
        )
        ingest_for_model(toas, model)
        cm = model.compile(toas, device=device, subtract_mean=False)
        x = cm.x0()
        ph = cm.absolute_phase(x)
        ph_int = ph.int_.cpu().numpy()
        ph_frac = ph.frac.cpu().numpy()
        f0 = float(cm.spin_frequency(x)[n // 2])
        psr = model.name or ""
        dm_p = model.params.get("DM")
        dm = float(dm_p.value) if dm_p is not None and dm_p.value else 0.0

        entries = []
        for s in range(nseg):
            sl = slice(s * nodes_per_seg, (s + 1) * nodes_per_seg)
            tmid = tmids[s]
            dt_min = (mjds[sl] - tmid) * 1440.0
            # reference phase = phase at the node closest to tmid
            iref = np.argmin(np.abs(dt_min))
            rint = ph_int[sl][iref]
            rfrac = ph_frac[sl][iref]
            resid = (
                (ph_int[sl] - rint) + (ph_frac[sl] - rfrac)
                - 60.0 * dt_min * f0
            )
            # fit in the scaled variable u = dt/(span/2) in [-1, 1]
            # with a Chebyshev basis, then convert to the monomial-in-
            # dt_minutes coefficients the tempo format stores: a raw
            # Vandermonde in dt_minutes (powers up to 30^11 ~ 2e16) is
            # so ill-conditioned the lstsq left cycle-level errors on
            # binary models — caught by the independent-oracle polyco
            # check (test_derived_l6.py::test_polycos_vs_independent_oracle)
            s_half = segment_minutes / 2.0
            u_nodes = dt_min / s_half
            cheb = np.polynomial.chebyshev.chebfit(
                u_nodes, resid, ncoeff - 1
            )
            a = np.polynomial.chebyshev.cheb2poly(cheb)
            a = np.pad(a, (0, ncoeff - len(a)))
            coeffs = a / s_half ** np.arange(ncoeff)
            entries.append(PolycoEntry(
                tmid_mjd=tmid, mjd_span_minutes=segment_minutes,
                rphase_int=float(rint), rphase_frac=float(rfrac),
                f0=f0, obs=obs, obsfreq_mhz=obsfreq_mhz,
                coeffs=coeffs, psrname=psr, dm=dm,
            ))
        return cls(entries)

    # -- evaluation -------------------------------------------------------
    #: span-membership slack in minutes: the tempo format's 11-decimal
    #: TMID snap (see generate) moves segment centers by up to ~5e-12
    #: day, so an epoch exactly on a segment edge can sit ~1e-9 min
    #: outside the nominal +-span/2 window; 1e-6 min (60 us) accepts
    #: those without letting genuinely uncovered epochs through.
    _SPAN_SLACK_MIN = 1e-6

    def _entry_for(self, mjd):
        for e in self.entries:
            if abs(mjd - e.tmid_mjd) * 1440.0 <= (
                e.mjd_span_minutes / 2 + self._SPAN_SLACK_MIN
            ):
                return e
        raise PintTpuError(f"MJD {mjd} outside polyco span")

    def _entry_indices(self, mjds) -> np.ndarray:
        """Vectorized segment lookup: nearest-tmid via searchsorted,
        then a span check — O((n + m) log m) instead of the O(n m)
        per-epoch linear scan (the serving engine's phase-predict hot
        path polls thousands of epochs per request;
        serve/engine.py::_predict)."""
        order = np.argsort([e.tmid_mjd for e in self.entries],
                           kind="stable")
        tmids = np.array(
            [self.entries[i].tmid_mjd for i in order]
        )
        pos = np.searchsorted(tmids, mjds)
        lo = np.clip(pos - 1, 0, len(tmids) - 1)
        hi = np.clip(pos, 0, len(tmids) - 1)
        nearest = np.where(
            np.abs(mjds - tmids[lo]) <= np.abs(mjds - tmids[hi]),
            lo, hi,
        )
        idx = order[nearest]
        for i, m in zip(np.atleast_1d(idx), np.atleast_1d(mjds)):
            e = self.entries[int(i)]
            if abs(m - e.tmid_mjd) * 1440.0 > (
                e.mjd_span_minutes / 2 + self._SPAN_SLACK_MIN
            ):
                raise PintTpuError(f"MJD {m} outside polyco span")
        return idx

    def eval_abs_phase(self, mjds):
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
        idx = self._entry_indices(mjds)
        ints = np.empty_like(mjds)
        fracs = np.empty_like(mjds)
        for i in np.unique(idx):
            sel = idx == i
            ints[sel], fracs[sel] = self.entries[int(i)].abs_phase(
                mjds[sel]
            )
        return ints, fracs

    def eval_spin_freq(self, mjds):
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
        idx = self._entry_indices(mjds)
        out = np.empty_like(mjds)
        for i in np.unique(idx):
            sel = idx == i
            out[sel] = self.entries[int(i)].spin_freq(mjds[sel])
        return out

    # -- tempo polyco.dat format ------------------------------------------
    def write(self, path):
        with open(path, "w") as f:
            for e in self.entries:
                rphase = f"{e.rphase_int + e.rphase_frac:.6f}"
                f.write(
                    f"{e.psrname:<10s} {'':9s}{0.0:11.2f}"
                    f"{e.tmid_mjd:20.11f}{e.dm:21.6f} {0.0:6.3f}"
                    f" {0.0:7.3f}\n"
                )
                f.write(
                    f"{rphase:>20s}{e.f0:18.12f}"
                    f"{_obs_code(e.obs):>5s}{e.mjd_span_minutes:5.0f}"
                    f"{len(e.coeffs):5d}{e.obsfreq_mhz:10.3f}\n"
                )
                for i in range(0, len(e.coeffs), 3):
                    row = e.coeffs[i:i + 3]
                    f.write(
                        "".join(f"{c:25.17e}" for c in row) + "\n"
                    )

    @classmethod
    def read(cls, path) -> "Polycos":
        entries = []
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        i = 0
        while i < len(lines):
            h1 = lines[i].split()
            h2 = lines[i + 1].split()
            psr = h1[0]
            tmid = float(h1[2])
            dm = float(h1[3]) if len(h1) > 3 else 0.0
            rphase = float(h2[0])
            f0 = float(h2[1])
            obs = h2[2]
            span = float(h2[3])
            ncoeff = int(h2[4])
            obsfreq = float(h2[5])
            nrows = (ncoeff + 2) // 3
            coeffs = []
            for r in range(nrows):
                coeffs.extend(
                    float(v) for v in lines[i + 2 + r].split()
                )
            i += 2 + nrows
            rint = np.floor(rphase)
            entries.append(PolycoEntry(
                tmid_mjd=tmid, mjd_span_minutes=span,
                rphase_int=rint, rphase_frac=rphase - rint, f0=f0,
                obs=obs, obsfreq_mhz=obsfreq,
                coeffs=np.asarray(coeffs[:ncoeff]), psrname=psr, dm=dm,
            ))
        return cls(entries)


def _obs_code(obs: str) -> str:
    """Tempo site code for the polyco header (single char where known)."""
    from pint_tpu_torch.observatory import get_observatory

    try:
        o = get_observatory(obs)
        for a in o.aliases:
            if len(a) == 1:
                return a
        return o.name[:4]
    except Exception:
        return str(obs)[:4]
