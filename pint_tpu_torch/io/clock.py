"""Observatory clock-correction files.

Counterpart of ``pint_tpu/io/clock.py``: piecewise-linear MJD ->
correction curves, read from tempo2 ``.clk`` files
(``# UTC(gbt) UTC`` header; ``mjd offset_seconds`` rows) or tempo
``time.dat`` files (``mjd offset_microseconds`` rows, site-coded).
Out-of-range policy: warn (default), error, or extrapolate-zero.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

from pint_tpu_torch.exceptions import ClockCorrectionOutOfRange, PintTpuError


class ClockFile:
    """Piecewise-linear clock correction: corr(mjd) seconds."""

    def __init__(
        self,
        mjd: np.ndarray,
        corr_s: np.ndarray,
        name: str = "",
        valid_beyond_ends: bool = False,
    ):
        order = np.argsort(mjd, kind="stable")
        self.mjd = np.asarray(mjd, dtype=np.float64)[order]
        self.corr_s = np.asarray(corr_s, dtype=np.float64)[order]
        self.name = name
        self.valid_beyond_ends = valid_beyond_ends

    @staticmethod
    def from_tempo2(path, name: str = "") -> "ClockFile":
        """Tempo2 .clk: '# FROM TO' header line, then 'mjd offset_s'."""
        mjds, corrs = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                try:
                    mjds.append(float(parts[0]))
                    corrs.append(float(parts[1]))
                except (ValueError, IndexError):
                    continue
        if not mjds:
            raise PintTpuError(f"no clock data in {path}")
        return ClockFile(
            np.array(mjds), np.array(corrs), name=name or Path(path).stem
        )

    @staticmethod
    def from_tempo(path, site: str = "", name: str = "") -> "ClockFile":
        """Tempo time.dat-style: 'mjd offset_us [offset2_us] [site]'.

        Offsets are microseconds; when a site column is present, rows are
        filtered to the requested one-letter code.
        """
        mjds, corrs = [], []
        with open(path) as f:
            for line in f:
                ls = line.strip()
                if not ls or ls.startswith(("#", "C", "c", "MJD")):
                    continue
                parts = ls.split()
                try:
                    mjd = float(parts[0])
                    off_us = float(parts[1])
                except (ValueError, IndexError):
                    continue
                if site and len(parts) >= 4 and parts[3] != site:
                    continue
                mjds.append(mjd)
                corrs.append(off_us * 1e-6)
        if not mjds:
            raise PintTpuError(f"no clock data for site {site!r} in {path}")
        return ClockFile(
            np.array(mjds), np.array(corrs), name=name or Path(path).stem
        )

    def evaluate(self, mjd, limits: str = "warn") -> np.ndarray:
        """Interpolate corrections (seconds) at mjd (float array).

        limits: 'warn' (clamp + warn), 'error', or 'none' (clamp silently).
        """
        mjd = np.asarray(mjd, dtype=np.float64)
        out_of_range = (mjd < self.mjd[0]) | (mjd > self.mjd[-1])
        if np.any(out_of_range) and not self.valid_beyond_ends:
            msg = (
                f"clock file {self.name}: {int(out_of_range.sum())} MJDs "
                f"outside [{self.mjd[0]:.1f}, {self.mjd[-1]:.1f}]"
            )
            if limits == "error":
                raise ClockCorrectionOutOfRange(msg)
            if limits == "warn":
                warnings.warn(msg)
        out = np.interp(mjd, self.mjd, self.corr_s)
        if not self.valid_beyond_ends:
            # extrapolate-zero beyond the tabulated span (module policy)
            out = np.where(out_of_range, 0.0, out)
        return out

    @property
    def first_mjd(self):
        return self.mjd[0]

    @property
    def last_mjd(self):
        return self.mjd[-1]

    def __add__(self, other: "ClockFile") -> "ClockFile":
        """Compose two corrections on the union grid (chain links)."""
        grid = np.union1d(self.mjd, other.mjd)
        total = self.evaluate(grid, limits="none") + other.evaluate(
            grid, limits="none"
        )
        return ClockFile(
            grid, total, name=f"{self.name}+{other.name}"
        )

    def write_tempo2(self, path, hdrline: str = ""):
        with open(path, "w") as f:
            f.write((hdrline or f"# {self.name}") + "\n")
            for m, c in zip(self.mjd, self.corr_s):
                f.write(f"{m:.6f} {c:.12e}\n")
