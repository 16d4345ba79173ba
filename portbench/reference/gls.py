"""The plain reference's GLS fit.

C = diag(sigma^2) + T diag(phi) T^T is applied through the Woodbury
identity (exactly the dense covariance's inverse, so it is the reference
of the dense step too).  A step normalises the design columns, forms
X^T C^-1 X for X = [M | r], solves the normal equations by a symmetric
eigendecomposition (directions below eps * p of the largest eigenvalue
dropped) and reports the decrement chi2 = r^T C^-1 r - dx^T b.  The fit
takes ``niter`` Gauss-Newton steps from the par values; its covariance
and chi2 are those of the last step, its parameters the state after it.

``dtype`` float32 is the control: the whole step's linear algebra in the
precision below the configuration's float64 (the residuals still from
the double-double phase, then rounded).
"""

from __future__ import annotations

import numpy as np

def column_norms(M):
    mx = np.max(np.abs(M), axis=0)
    mx = np.where(mx == 0, 1.0, mx).astype(M.dtype)
    norm = np.sqrt(np.sum(np.square(M / mx), axis=0)) * mx
    return np.where(norm == 0, 1.0, norm).astype(M.dtype)


def _spd_solve(S, B):
    """S^-1 B for symmetric positive-definite S, Jacobi-equilibrated."""
    d = 1.0 / np.sqrt(np.diag(S))
    L = np.linalg.cholesky(S * np.outer(d, d))
    Y = np.linalg.solve(L, d[:, None] * B)
    return d[:, None] * np.linalg.solve(L.T, Y)


def gls_step(r, M, sigma, T, phi, dtype=np.float64):
    """(dx (p,), cov (p, p), chi2) of one step, M with its offset column."""
    r, M, sigma, T, phi = (np.asarray(a, dtype) for a in (r, M, sigma, T,
                                                          phi))
    norm = column_norms(M)
    X = np.concatenate([M / norm, r[:, None]], axis=1)
    ninv = (1.0 / np.square(sigma)).astype(dtype)
    NX = X * ninv[:, None]
    G = X.T @ NX
    if T.shape[1]:
        TNX = T.T @ NX
        Sigma = np.diag(1.0 / phi) + T.T @ (T * ninv[:, None])
        G = G - TNX.T @ _spd_solve(Sigma, TNX)
    A, b, rcr = G[:-1, :-1], -G[:-1, -1], G[-1, -1]
    A = 0.5 * (A + A.T)
    w, V = np.linalg.eigh(A)
    keep = w >= np.finfo(dtype).eps * len(w) * np.max(w)
    winv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0).astype(dtype)
    covn = (V * winv) @ V.T
    dxn = covn @ b
    chi2 = rcr - dxn @ b
    return (dxn / norm).astype(np.float64), \
        (covn / np.outer(norm, norm)).astype(np.float64), float(chi2)


def fit(model, steps: int, dtype=np.float64):
    """-> (x: deltas from the par values, cov of x, chi2, the first
    step's inputs {"r", "M", "sigma", "T", "phi"} at the par values)."""
    sigma, T, phi = model.noise()
    x = np.zeros(len(model.free))
    first = None
    for _ in range(steps):
        r, M = model.residuals(x), model.design(x)
        if first is None:
            first = {"r": r, "M": M, "sigma": sigma, "T": T, "phi": phi}
        dx, cov, chi2 = gls_step(r, M, sigma, T, phi, dtype)
        x = x + dx[1:]
    return x, cov[1:, 1:], chi2, first
