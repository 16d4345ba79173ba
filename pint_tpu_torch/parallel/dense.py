"""Blocked Cholesky factorization of a dense covariance, on one device.

Counterpart of ``pint_tpu/parallel/dense.py`` (``blocked_cholesky``,
``fast_cholesky32``) for a single device.  The full-covariance GLS step
(``fitting/gls.py::gls_step_full_cov``) factors an n x n covariance, the
O(n^3) work of the reference's ``full_cov=True``; a right-looking blocked
algorithm puts nearly all of it into the trailing-submatrix products, one
(m, b) @ (b, m) GEMM a block column.

The reference shards that GEMM over a mesh and overlaps it with the next
panel (its ``mesh``, ``lookahead`` and ``update_chunks``); those come with
the multi-GPU slice.  Here the schedule is the sequential one, which the
reference computes with ``PINT_TPU_DENSE_LOOKAHEAD=0``.  It runs in place
on one padded copy of the operand: the factor's panels overwrite the
block columns they came from and each trailing update is one ``addmm_``
into the trailing block, so a factorization holds two n x n tensors (the
operand and its factor), not one a block column.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.ops.ffgram import nan_cholesky


def blocked_cholesky(C, block: int = 1024, precision: str = "highest",
                     panel: str = "solve", diag_bump: float = 0.0):
    """Lower Cholesky factor of SPD C (n, n), any n, in C's dtype.

    Right-looking and blocked: for each block column, the b x b diagonal
    block is factored by the native Cholesky (``nan_cholesky``: NaN where
    it fails, and the NaN then fills every later block, as the
    reference's factor does), the panel below it is solved against that
    factor, and the trailing matrix takes the rank-b update
    A -= pan pan^T, the full (m, m) square as in the reference.

    ``precision`` ('highest' or 'high') names the reference's two
    trailing-GEMM rungs.  On the TPU 'high' is three bf16 passes; on the
    card both are a full-precision GEMM in C's dtype: the port never
    enables TF32, and a single reduced-precision pass would drive the
    Schur cancellation 1 - |pan row|^2 negative on red-noise covariances
    and NaN the next diagonal block (the reference's note at
    ``pint_tpu/parallel/dense.py:142-152``).

    ``panel`` ('solve' or 'inv'): the panel by a triangular solve against
    the diagonal factor, or by a GEMM against its explicit inverse.

    ``diag_bump`` adds a ridge to each diagonal block as it is factored:
    the same as factoring C + bump I, since earlier updates never touch a
    later block's ridge, without an n x n copy.

    n that is not a multiple of ``block`` is padded with a unit diagonal;
    the padded factor is block-diagonal [L, I], so its leading (n, n) is
    exact."""
    if precision not in ("highest", "high"):
        raise ValueError(f"unknown precision {precision!r}")
    if panel not in ("solve", "inv"):
        raise ValueError(f"unknown panel {panel!r}")
    n = C.shape[0]
    pad = (-n) % block
    npad = n + pad
    A = torch.nn.functional.pad(C, (0, pad, 0, pad)) if pad else C.clone()
    A.diagonal()[n:].fill_(1.0)
    eye = torch.eye(block, dtype=C.dtype, device=C.device)
    for j in range(0, npad, block):
        e = j + block
        D = A[j:e, j:e]
        if diag_bump:
            D = D + diag_bump * eye
        Ld = nan_cholesky(D)
        A[j:e, j:e] = Ld
        if e == npad:
            break
        sub = A[e:, j:e]
        if panel == "inv":
            Ldinv = torch.linalg.solve_triangular(Ld, eye, upper=False)
            sub.copy_(sub @ Ldinv.mT)
        else:
            sub.copy_(torch.linalg.solve_triangular(Ld.mT, sub, upper=True,
                                                    left=False))
        A[j:e, e:].zero_()
        # the trailing update, in place: A[e:, e:] -= pan pan^T
        A[e:, e:].addmm_(sub, sub.mT, alpha=-1.0)
    return A[:n, :n] if pad else A


def fast_cholesky32(Aeq32, block: int = 512, ridge: float = 3e-5):
    """Blocked f32 Cholesky of an equilibrated (unit-diagonal) SPD
    operand, for use as a preconditioner only: the factor of the refined
    solves ``ops/ffgram.py::chol_solve_ir`` and ``woodbury_chol_solve_ir``,
    whose residuals apply the true f64 operator, so the refined solution
    converges to the exact solve whatever the factor's own error.

    The reference's recipe: ``blocked_cholesky`` at its 'high' rung
    (on the card the same full-f32 GEMM as 'highest'), panels by
    triangular solve, and a ridge of ``ridge`` on each diagonal block,
    which keeps a tiny trailing pivot from going negative under the
    update's rounding.  ``block`` doubles until the operand has at most 32
    block columns.  Not for a direct (unrefined) solve."""
    while Aeq32.shape[0] > 32 * block:
        block *= 2
    return blocked_cholesky(Aeq32, block=block, precision="high",
                            panel="solve", diag_bump=ridge)
