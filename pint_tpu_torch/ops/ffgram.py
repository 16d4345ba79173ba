"""Mixed-precision (f32) linear algebra for the GLS hot path.

Counterpart of ``pint_tpu/ops/ffgram.py``:

- ``gram32`` / ``gram32_joint``: A^T diag(w) A as chunked batched f32
  products whose per-chunk partials accumulate in f64.  Chunking bounds
  the f32 in-chunk accumulation error (~3e-8 relative at chunk=128).
- ``make_matmul_split32``: f64 products through an error-free two-term
  f32 split of both operands, with f64 chunk accumulation.
- ``chol_solve_ir``: SPD solve by Jacobi equilibration, an f32 Cholesky,
  and f64 iterative refinement, with the NaN-poison residual check.

Every f32 product here must be a full f32 product: the module never sets
PyTorch's TF32 switches, and on the card ``torch.matmul`` in float32 is
exact-product f32 unless a caller turned
``torch.backends.cuda.matmul.allow_tf32`` on.
"""

from __future__ import annotations

import torch

F32 = torch.float32
F64 = torch.float64


def _chunked_gram_f32(Y, chunk: int):
    """Y^T Y for f32 Y (n, q) -> f64 (q, q); each f32 partial Gram
    accumulates <= ``chunk`` rows before switching to f64."""
    n, q = Y.shape
    n_pad = (n + chunk - 1) // chunk * chunk
    Yp = torch.zeros((n_pad, q), dtype=F32, device=Y.device)
    Yp[:n] = Y
    Yb = Yp.reshape(n_pad // chunk, chunk, q)
    G = torch.bmm(Yb.transpose(1, 2), Yb)
    return torch.sum(G.to(F64), dim=0)


def gram32(A, w, chunk: int = 128):
    """G = A^T diag(w) A (f64 in/out) via f32 products; sqrt(w) row
    scaling in f64 before the single f32 cast."""
    s = torch.sqrt(w)
    Y = (A * s[:, None]).to(F32)
    return _chunked_gram_f32(Y, chunk)


def gram32_joint(T32, A, w, chunk: int = 128):
    """Joint Gram of [T | A] under diag(w): T held in f32 (noise basis),
    A f64 (design and residual columns).  Returns (G_TT (k, k),
    G_TA (k, p), G_AA (p, p)) f64 with G_XY = X^T W Y."""
    s = torch.sqrt(w)
    k = T32.shape[1]
    Ts = T32 * s.to(F32)[:, None]
    As = (A * s[:, None]).to(F32)
    G = _chunked_gram_f32(torch.cat([Ts, As], dim=1), chunk)
    return G[:k, :k], G[:k, k:], G[k:, k:]


def make_matmul_split32(A, chunk: int = 128):
    """Pre-split A (m, K) f64 into chunked two-term f32 blocks and return
    B -> A @ B.  Callers that apply the same A repeatedly (the refinement
    loop) split once."""
    m, K = A.shape
    K_pad = (K + chunk - 1) // chunk * chunk
    nc = K_pad // chunk
    Ap = torch.zeros((m, K_pad), dtype=A.dtype, device=A.device)
    Ap[:, :K] = A
    A_hi = Ap.to(F32)
    A_lo = (Ap - A_hi.to(F64)).to(F32)
    Ab_hi = A_hi.reshape(m, nc, chunk).transpose(0, 1)
    Ab_lo = A_lo.reshape(m, nc, chunk).transpose(0, 1)

    def bmm(X, Y):
        return torch.bmm(X, Y).to(F64)

    def matmul(B):
        Bp = torch.zeros((K_pad, B.shape[1]), dtype=B.dtype, device=B.device)
        Bp[:K] = B
        B_hi = Bp.to(F32)
        B_lo = (Bp - B_hi.to(F64)).to(F32)
        Bb_hi = B_hi.reshape(nc, chunk, B.shape[1])
        Bb_lo = B_lo.reshape(nc, chunk, B.shape[1])
        C = bmm(Ab_hi, Bb_hi) + bmm(Ab_hi, Bb_lo) + bmm(Ab_lo, Bb_hi)
        return torch.sum(C, dim=0)

    return matmul


def nan_cholesky(A):
    """Cholesky factor of A, all NaN where A is not positive-definite.
    ``torch.linalg.cholesky`` raises there (and needs a host sync to do
    so); the NaN flows to the fit's finite check instead, as in the
    reference."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _check_poison(X, Req, Beq, check_rtol):
    """NaN-poison the solution when the final equilibrated residual
    exceeds ``check_rtol`` relative to the equilibrated RHS — a plain
    ``where`` on a scalar predicate, so the poison flows to the fit's
    finite check.  Product form (|R| <= rtol |B|): an exactly-zero RHS has
    an exactly-zero residual and passes."""
    ok = torch.max(torch.abs(Req)) <= check_rtol * torch.max(torch.abs(Beq))
    return torch.where(ok, X, torch.full_like(X, float("nan")))


def chol_solve_ir(A, B, refine: int = 2, cholesky=None, check_rtol=None):
    """Solve SPD A X = B (f64) with an f32 Cholesky + f64 iterative
    refinement.  Jacobi equilibration first (power-law Woodbury matrices
    have ~1e10 dynamic range on the diagonal, beyond an f32 Cholesky);
    ``refine`` residual-correction passes then recover f64-grade accuracy.
    ``cholesky`` swaps the factorization; ``check_rtol`` (None = no check)
    arms the post-refinement residual check."""
    if cholesky is None:
        cholesky = nan_cholesky
    d = torch.sqrt(torch.diagonal(A))
    dinv = 1.0 / d
    Aeq = A * torch.outer(dinv, dinv)
    Beq = B * dinv[:, None]
    L32 = cholesky(Aeq.to(F32))

    def solve32(R):
        Y = torch.linalg.solve_triangular(L32, R.to(F32), upper=False)
        Z = torch.linalg.solve_triangular(L32.T, Y, upper=True)
        return Z.to(F64)

    if A.shape[0] >= 1024:
        mm = make_matmul_split32(Aeq)  # split Aeq once for all passes
    else:
        def mm(X):
            return Aeq @ X

    X = solve32(Beq)
    for _ in range(refine):
        X = X + solve32(Beq - mm(X))
    if check_rtol is not None:
        X = _check_poison(X, Beq - mm(X), Beq, check_rtol)
    return X * dinv[:, None]
