"""Taylor-series (Horner) evaluation — the spin-phase kernel.

Counterpart of ``pint_tpu/ops/taylor.py``: sum_i coeffs[i] * x^i / i! by
Horner's rule, with dt a DD and DD accumulation so that F0*dt keeps
cycle-level exactness at 1e12 cycles.  Coefficients are f64 scalars or
DD; the plain-f64 variants serve small-magnitude series (DM(t), orbital
frequencies).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from pint_tpu_torch.ops.dd import DD


def _coeff(c, like) -> DD:
    return c if isinstance(c, DD) else DD.from_float(c, like)


def taylor_horner_dd(dt: DD, coeffs: Sequence) -> DD:
    """sum_i coeffs[i] * dt^i / i! with DD accumulation."""
    if len(coeffs) == 0:
        return DD.zeros(dt.hi.shape, dt.hi.device)
    acc = DD.from_float(torch.zeros_like(dt.hi))
    for i in reversed(range(len(coeffs))):
        c = _coeff(coeffs[i], dt.hi)
        if i >= 2:
            c = c / float(math.factorial(i))  # DD-exact division
        acc = acc * dt + c
    return acc


def taylor_horner_deriv_dd(dt: DD, coeffs: Sequence, deriv_order: int = 1) -> DD:
    """d^n/dt^n of taylor_horner_dd at dt."""
    n = deriv_order
    if len(coeffs) <= n:
        return DD.zeros(dt.hi.shape, dt.hi.device)
    acc = DD.from_float(torch.zeros_like(dt.hi))
    for i in reversed(range(len(coeffs) - n)):
        c = _coeff(coeffs[i + n], dt.hi)
        if i >= 2:
            c = c / float(math.factorial(i))
        acc = acc * dt + c
    return acc


def taylor_horner(dt, coeffs: Sequence):
    """Plain-f64 variant for small-magnitude uses (DM(t) polynomials)."""
    acc = torch.zeros_like(dt)
    for i in reversed(range(len(coeffs))):
        acc = acc * dt + coeffs[i] / float(math.factorial(i))
    return acc


def taylor_horner_deriv(dt, coeffs: Sequence, deriv_order: int = 1):
    """Plain-f64 d^n/dt^n of taylor_horner (the orbital frequency of an
    FBn series): coefficients shifted by n and divided by i!, then
    Horner's rule, as the reference."""
    n = deriv_order
    if len(coeffs) <= n:
        return torch.zeros_like(dt)
    shifted = [coeffs[i + n] / float(math.factorial(i))
               for i in range(len(coeffs) - n)]
    acc = torch.zeros_like(dt)
    for c in reversed(shifted):
        acc = acc * dt + c
    return acc
