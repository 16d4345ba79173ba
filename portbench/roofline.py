"""Operation and byte counts of the fit step's linear algebra, from its
shapes, and the card's published peaks.

Peaks: NVIDIA H100 SXM data sheet (dense rates, no sparsity), at the
700 W power limit: 3.35 TB/s of HBM3, 67 TFLOP/s in float64 on the
tensor cores and 67 TFLOP/s in float32 outside them.  A share is stated
against these peaks with the card's power limit beside it.

Shapes: ``n`` TOAs, ``k`` noise-basis columns (red-noise harmonics and
ECORR epochs), ``p1`` design columns with the offset plus the residual
column, so the joint Gram is q = k + p1 wide.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F64_TENSOR_FLOPS = 67e12
F32_FLOPS = 67e12


def gram_flops(n: int, k: int, p1: int) -> float:
    """The joint Gram [T | X]^T N^-1 [T | X]: q (q + 1) / 2 entries of n
    multiply-adds each."""
    q = k + p1
    return float(n) * q * (q + 1)


def gram_bytes(n: int, k: int, p1: int) -> float:
    """Each input read once (T, X = [M | r] and the weights, all float64:
    the kernel rounds T to float32 in registers) and the q x q float64
    result written once."""
    q = k + p1
    return float(n) * (k * 8 + p1 * 8 + 8) + q * q * 8.0


def gram_bound_s(n: int, k: int, p1: int) -> float:
    """The least time of the joint Gram: the larger of its operations at
    the float64 tensor-core peak and its bytes at the HBM bandwidth."""
    return max(gram_flops(n, k, p1) / F64_TENSOR_FLOPS,
               gram_bytes(n, k, p1) / HBM_BYTES_PER_S)


def factor_flops(n: int) -> float:
    """A dense Cholesky factorization of an n x n matrix."""
    return n ** 3 / 3.0


def factor_bound_s(n: int) -> float:
    """The float32 factor of the dense step: n^3 / 3 at the float32 peak
    (its n^2 float32 bytes at the HBM bandwidth take far less)."""
    return max(factor_flops(n) / F32_FLOPS, 4.0 * n * n / HBM_BYTES_PER_S)


def _normal_eqs_flops(p1: int) -> float:
    """The p x p normal equations (p = p1 - 1): a factor and two
    triangular solves against [b | I]."""
    p = p1 - 1
    return p ** 3 / 3.0 + 2.0 * p * p * (p + 1)


def woodbury_step_flops(n: int, k: int, p1: int) -> float:
    """The mixed Woodbury step's linear algebra: the joint Gram, the k x k
    factor, its two triangular solves against T^T N^-1 X, the p1 x p1
    correction, and the normal equations."""
    return (gram_flops(n, k, p1) + factor_flops(k) + 2.0 * k * k * p1
            + 2.0 * k * p1 * p1 + _normal_eqs_flops(p1))


def dense_step_flops(n: int, k: int, p1: int, refine: int = 2) -> float:
    """The dense step's linear algebra: the equilibrated covariance
    W W^T (its lower half), its factor, the float32 solves of the first
    pass and each refinement (two triangular solves a column), each
    refinement's residual through N X + T (phi (T^T X)), X^T C^-1 X, and
    the normal equations."""
    solves = 1 + refine
    return (float(n) * n * k + factor_flops(n) + solves * 2.0 * n * n * p1
            + refine * 4.0 * n * k * p1 + 2.0 * n * p1 * p1
            + _normal_eqs_flops(p1))


def step_flops(shape: dict, full_cov: bool) -> float:
    n, k, p1 = shape["n"], shape["k"], shape["p1"]
    return (dense_step_flops(n, k, p1) if full_cov
            else woodbury_step_flops(n, k, p1))
