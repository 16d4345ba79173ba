"""Host-side helpers: weighted statistics, observing-epoch interval
splitting, DMX summaries (dmxparse), content hashing for caches, and
file-or-object opening.

Counterpart of ``pint_tpu/utils/misc.py`` (reference parity:
src/pint/utils.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os

import numpy as np


def weighted_mean(values, errors, dof: bool = False):
    """Weighted mean and its uncertainty; with ``dof`` also the reduced
    chi2 about the mean (reference: utils.weighted_mean)."""
    v = np.asarray(values, dtype=np.float64)
    w = 1.0 / np.square(np.asarray(errors, dtype=np.float64))
    mean = np.sum(w * v) / np.sum(w)
    err = 1.0 / np.sqrt(np.sum(w))
    if not dof:
        return mean, err
    chi2 = np.sum(w * (v - mean) ** 2) / max(len(v) - 1, 1)
    return mean, err, chi2


def split_intervals(mjds, gap_days: float = 0.5):
    """Split MJDs into observing-epoch groups at gaps wider than
    ``gap_days``: half-open (start, end) index pairs of the sorted MJDs."""
    mjds = np.asarray(mjds, dtype=np.float64)
    s = mjds[np.argsort(mjds)]
    breaks = np.flatnonzero(np.diff(s) > gap_days) + 1
    bounds = np.concatenate([[0], breaks, [len(s)]])
    return [(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1)]


def dmx_ranges_from_toas(toas, gap_days: float = 15.0, pad_days=0.1):
    """Suggested (DMXR1, DMXR2) MJD ranges covering the TOAs."""
    s = np.sort(toas.mjd_float())
    return [(s[i0] - pad_days, s[i1 - 1] + pad_days)
            for i0, i1 in split_intervals(s, gap_days)]


def dmxparse(model) -> dict:
    """Summary of a model's DMX ranges (reference: utils.dmxparse): the
    indices, epochs, bounds, values, uncertainties and their mean."""
    comp = model.components.get("DispersionDMX")
    if comp is None:
        raise ValueError("model has no DispersionDMX component")
    idx = comp.dmx_indices
    r1 = np.array([_mjd(comp.params[f"DMXR1_{i:04d}"].value) for i in idx])
    r2 = np.array([_mjd(comp.params[f"DMXR2_{i:04d}"].value) for i in idx])
    val = np.array([float(comp.params[f"DMX_{i:04d}"].value) for i in idx])
    unc = np.array([comp.params[f"DMX_{i:04d}"].uncertainty or np.nan
                    for i in idx])
    return {
        "dmx_index": np.asarray(idx),
        "dmx_epochs": (r1 + r2) / 2.0,
        "dmx_r1": r1,
        "dmx_r2": r2,
        "dmxs": val,
        "dmx_verrs": unc,
        "mean_dmx": float(np.nanmean(val)) if len(val) else np.nan,
    }


def _mjd(v) -> float:
    """An MJD value as a float (an epoch pair: day + seconds / 86400)."""
    if isinstance(v, tuple):
        return v[0] + float(v[1].to_float()) / 86400.0
    return float(v)


def compute_hash(*items) -> str:
    """Stable content hash for cache keys: file paths hash their bytes;
    other values hash their repr."""
    h = hashlib.sha256()
    for it in items:
        if isinstance(it, (str, os.PathLike)) and os.path.isfile(it):
            with open(it, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
        else:
            h.update(repr(it).encode())
        h.update(b"\x00")
    return h.hexdigest()


def open_or_use(obj, mode: str = "r"):
    """Context manager: open(path), or pass a file object through."""
    if isinstance(obj, (str, os.PathLike)):
        return open(obj, mode)
    return contextlib.nullcontext(obj)


def lines_of(obj):
    """Iterate the lines of a path, a file object or a multi-line str."""
    if isinstance(obj, str) and "\n" in obj:
        return io.StringIO(obj)
    return open_or_use(obj)
