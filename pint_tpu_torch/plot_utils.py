"""Plotting helpers (reference parity: src/pint/plot_utils.py and the
pintk residual views).

Counterpart of ``pint_tpu/plot_utils.py``: matplotlib is imported inside
each function, so a host without it raises ImportError there and
nowhere else.
"""

from __future__ import annotations

import numpy as np


def phaseogram(
    mjds, phases, weights=None, bins: int = 64, rotate: float = 0.0,
    ax=None, plotfile=None,
):
    """Two-panel phaseogram: pulse profile + phase vs time (reference:
    plot_utils.phaseogram for photon data)."""
    import matplotlib

    if plotfile:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ph = np.mod(np.asarray(phases) + rotate, 1.0)
    mjds = np.asarray(mjds)
    if ax is None:
        fig, (ax0, ax1) = plt.subplots(
            2, 1, sharex=True, figsize=(6, 8),
            gridspec_kw={"height_ratios": [1, 3]},
        )
    else:
        ax0, ax1 = ax
        fig = ax0.figure
    # doubled phase axis, standard pulsar convention
    ph2 = np.concatenate([ph, ph + 1.0])
    w2 = None if weights is None else np.concatenate([weights, weights])
    ax0.hist(ph2, bins=2 * bins, range=(0, 2), weights=w2,
             histtype="step", color="k")
    ax0.set_ylabel("photons")
    ax1.scatter(
        ph2, np.concatenate([mjds, mjds]), s=1.0,
        c="k" if weights is None else np.concatenate([weights, weights]),
        cmap=None if weights is None else "viridis",
    )
    ax1.set_xlim(0, 2)
    ax1.set_xlabel("pulse phase")
    ax1.set_ylabel("MJD")
    if plotfile:
        fig.savefig(plotfile)
        plt.close(fig)
    return fig


def plot_residuals(
    toas, resids, ax=None, plotfile=None, label=None, in_us=True,
):
    """Residuals vs MJD with error bars (the pintk plk-view
    equivalent)."""
    import matplotlib

    if plotfile:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure
    r = np.asarray(resids.time_resids if hasattr(resids, "time_resids")
                   else resids)
    scale = 1e6 if in_us else 1.0
    ax.errorbar(
        toas.mjd_float(), r * scale, yerr=np.asarray(toas.error_us)
        * (1.0 if in_us else 1e-6),
        fmt=".", ms=3, label=label,
    )
    ax.set_xlabel("MJD")
    ax.set_ylabel(f"residual ({'us' if in_us else 's'})")
    if label:
        ax.legend()
    if plotfile:
        fig.savefig(plotfile)
        plt.close(fig)
    return fig


def plot_random_models(fitter, n_models=30, ax=None, plotfile=None):
    """Overlay residual curves drawn from the fit covariance
    (reference: pintk random-models view / calculate_random_models)."""
    import matplotlib

    if plotfile:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pint_tpu_torch.simulation import calculate_random_models

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure
    curves = calculate_random_models(fitter, n_models=n_models)
    mjd = fitter.toas.mjd_float()
    order = np.argsort(mjd)
    for c in curves:
        ax.plot(mjd[order], c[order] * 1e6, alpha=0.2, color="C0")
    rr = fitter.resids
    r = rr.toa.time_resids if hasattr(rr, "toa") else rr.time_resids
    ax.errorbar(
        mjd, np.asarray(r) * 1e6,
        yerr=np.asarray(fitter.toas.error_us), fmt=".k", ms=3,
    )
    ax.set_xlabel("MJD")
    ax.set_ylabel("residual (us)")
    if plotfile:
        fig.savefig(plotfile)
        plt.close(fig)
    return fig
