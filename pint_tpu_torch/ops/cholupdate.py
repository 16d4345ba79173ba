"""Rank-k Cholesky updates for the O(append) streaming solver.

Counterpart of ``pint_tpu/ops/cholupdate.py``.  The streaming state keeps
the Woodbury inner matrix Sigma = phi^-1 + T^T N^-1 T and a Cholesky
factor of it; appending j TOAs adds V V^T with V = T_j^T sqrt(Ninv_j)
(k, j), and the factor follows by j rank-1 updates in O(j k^2) instead of
a fresh O(k^3) factorization.

The update is LINPACK's positive-update recurrence: per column, a scaled
Givens rotation of the column against the update vector.  The reference
scans it over the factor's columns with full-vector masked updates; here
the column loop is a Python loop, so each column's index is a Python
int and static slices take the place of the masks (the same arithmetic
on the same elements).  Every operation stays on the device with no host
read, so an append is captured whole in a step program.  A non-positive
or NaN pivot makes ``sqrt`` or the division NaN, and the NaN spreads
through the remaining columns: the factor poisons itself and the
streaming drift check fails (``factor_solve_ir``).

Precision (``ops/solve_policy.py::stream_factor_dtype``): the factor is
f64 on the CPU and equilibrated f32 on the card, where every solve with
it refines against the true f64 matrix with the NaN-poison residual
check, the ``ops/ffgram.py::chol_solve_ir`` recipe.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _rank1_update_(L, w):
    """Overwrite L (k, k), lower-triangular, with the factor of
    L L^T + w w^T; ``w`` (k,) is overwritten too.  LINPACK's recurrence,
    one column at a time: the column below the diagonal takes the
    rotation, then the update vector rotates against the updated
    column."""
    for j in range(L.shape[0]):
        # views: read before L[j, j] is written; w[j] is never written
        Ljj, wj = L[j, j], w[j]
        r = torch.sqrt(Ljj * Ljj + wj * wj)
        c = r / Ljj
        s = wj / Ljj
        col = L[j + 1:, j]
        wb = w[j + 1:]
        col.copy_((col + s * wb) / c)
        L[j, j] = r
        wb.copy_(c * wb - s * col)


def chol_update(L, V):
    """Factor of L L^T + V V^T for lower-triangular L (k, k) and an update
    block V (k, j): j rank-1 recurrences, O(j k^2), in L's dtype.  L is
    left as it was.  k = 0 (a pure-white state) and j = 0 (no live rows)
    return L; a zero column of V (a pad row of zero weight) is an exact
    identity update (r = Ljj, c = 1, s = 0)."""
    if L.shape[0] == 0 or V.shape[1] == 0:
        return L
    L = L.clone()
    W = V.to(L.dtype).clone()
    for i in range(W.shape[1]):
        _rank1_update_(L, W[:, i])
    return L


def chol_factor_solve(L, B):
    """X = (L L^T)^-1 B by two triangular solves with a maintained factor
    (the f64 path, where the factor is the truth)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def factor_solve_ir(L, A_true, B, refine: int = 2, check_rtol=None):
    """Solve A_true X = B (f64) with a maintained factor ``L`` of (an
    approximation of) A_true as the preconditioner: ``L`` may be f32 and
    carries accumulated update roundoff, but each of the ``refine``
    sweeps applies the true f64 matrix, so the refined solution converges
    to the exact solve.  ``check_rtol`` (None = no check) NaN-poisons the
    solution where the final residual exceeds ``check_rtol`` relative to
    B (max |R| <= rtol max |B|, a ``torch.where`` on the device)."""
    if L.shape[0] == 0:
        return B

    def solve_pre(R):
        return chol_factor_solve(L, R.to(L.dtype)).to(F64)

    X = solve_pre(B)
    for _ in range(refine):
        X = X + solve_pre(B - A_true @ X)
    if check_rtol is not None:
        R = B - A_true @ X
        ok = torch.max(torch.abs(R)) <= check_rtol * torch.max(torch.abs(B))
        X = torch.where(ok, X, torch.full_like(X, float("nan")))
    return X
