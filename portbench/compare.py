"""The comparison that decides ``correct``.

The reference (``portbench/reference``) fits the same starting par text
to the same TOA table in float64, taking the cell's ``maxiter`` steps as
the program does.  Every answer the program gave (each fit of the
set-up, the window and the trace) is held to it by three numbers, each
against the cell's limit:

- ``param_gap_sigma``: the largest |x_program - x_reference| of any
  fitted parameter, x its change from the starting value, in units of
  the reference's uncertainty;
- ``cov_gap``: the largest |C_program - C_reference| of any entry of the
  parameter covariance over the product of the two parameters'
  reference uncertainties;
- ``chi2_gap``: |chi2_program / chi2_reference - 1|.

The inputs of the program's step, brought back once from the cell's own
fitter at full size at the starting values (``Program.step_inputs``),
are held to the reference's first step by three more:

- ``resid_gap_sigma``: the largest |r_program - r_reference| over the
  reference's scaled sigma of that TOA (the double-double phase and the
  delays);
- ``design_gap``: the largest gap of any design-matrix entry (offset
  column included) over the largest |entry| of its column in the
  reference, so a column scaled wrong reads as its error;
- ``noise_gap``: the largest relative gap of the scaled sigma (EFAC,
  EQUAD) or of a basis weight (ECORR, red noise), or of a basis entry
  over its column's largest.

A number that is not finite, or answers of the wrong shape, read 1e300.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import gls
from portbench.reference.model import ReferenceModel

BIG = 1e300
ANSWER_NUMBERS = ("param_gap_sigma", "cov_gap", "chi2_gap")
INPUT_NUMBERS = ("resid_gap_sigma", "design_gap", "noise_gap")


def reference_fit(par: str, table: dict, steps: int,
                  dtype=np.float64) -> dict:
    ref = ReferenceModel(par, table)
    x, cov, chi2, first = gls.fit(ref, steps, dtype=dtype)
    return {"names": ref.free, "x": x, "cov": cov, "chi2": chi2,
            "inputs": first}


def _finite(v: float) -> float:
    return float(v) if np.isfinite(v) else BIG


def gaps(answer: dict, ref: dict) -> dict:
    """The three numbers of one answer against the reference's fit."""
    if sorted(answer["names"]) != sorted(ref["names"]):
        return dict.fromkeys(ANSWER_NUMBERS, BIG)
    idx = [answer["names"].index(n) for n in ref["names"]]
    x = answer["x"][idx]
    cov = answer["cov"][np.ix_(idx, idx)]
    sig = np.sqrt(np.diag(ref["cov"]))
    with np.errstate(invalid="ignore", divide="ignore"):
        param = np.max(np.abs(x - ref["x"]) / sig)
        cg = np.max(np.abs(cov - ref["cov"]) / np.outer(sig, sig))
        chi2 = abs(answer["chi2"] / ref["chi2"] - 1.0)
    return {"param_gap_sigma": _finite(param), "cov_gap": _finite(cg),
            "chi2_gap": _finite(chi2)}


def _column_gap(a, b) -> float:
    """The largest |a - b| of any entry over its column's largest |b|."""
    scale = np.max(np.abs(b), axis=0)
    return float(np.max(np.max(np.abs(a - b), axis=0)
                        / np.where(scale > 0, scale, 1.0)))


def input_gaps(got: dict, ref: dict) -> dict:
    """The three numbers of the program's step inputs (``names``, ``r``,
    ``M`` with its offset column first and its parameters in ``names``
    order, ``sigma``, ``T``, ``phi``) against the reference's first
    step."""
    want = ref["inputs"]
    if (got is None or sorted(got["names"]) != sorted(ref["names"])
            or any(np.shape(got[k]) != np.shape(want[k])
                   for k in ("r", "M", "sigma", "T", "phi"))):
        return dict.fromkeys(INPUT_NUMBERS, BIG)
    idx = [got["names"].index(n) for n in ref["names"]]
    M = got["M"][:, [0] + [1 + i for i in idx]]
    with np.errstate(invalid="ignore", divide="ignore"):
        resid = np.max(np.abs(got["r"] - want["r"]) / want["sigma"])
        design = _column_gap(M, want["M"])
        noise = max(
            np.max(np.abs(got["sigma"] - want["sigma"]) / want["sigma"]),
            np.max(np.abs(got["phi"] - want["phi"]) / want["phi"],
                   initial=0.0),
            _column_gap(got["T"], want["T"]) if want["T"].shape[1] else 0.0)
    return {"resid_gap_sigma": _finite(resid), "design_gap": _finite(design),
            "noise_gap": _finite(noise)}


def check(par: str, table: dict, answers: list, limits: dict, steps: int,
          inputs: dict | None = None) -> dict:
    """{number: {"value": the worst over the answers, "limit": ...}}."""
    ref = reference_fit(par, table, steps)
    worst = dict.fromkeys(limits, 0.0)
    for a in answers:
        for k, v in gaps(a, ref).items():
            if k in worst:
                worst[k] = max(worst[k], v)
    for k, v in input_gaps(inputs, ref).items():
        if k in worst:
            worst[k] = max(worst[k], v)
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}
