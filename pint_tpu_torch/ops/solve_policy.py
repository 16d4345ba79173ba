"""Per-solve precision policy for the iteratively-refined GLS solves.

Counterpart of ``pint_tpu/ops/solve_policy.py``.  The one place that
decides, per solve, whether the f32-Cholesky + f64-refinement recipe
applies and whether the mixed step's joint Gram goes through the fused
kernel.  The backend gate is the device of the step's tensors: the CUDA
card takes the mixed recipes, the CPU keeps the exact f64 paths.

Knobs, read at every call:

- ``PINT_TPU_TORCH_SOLVE_IR``: ``0`` restores the pre-policy solves on
  every device (callers pass ``check_rtol=None``);
  ``force`` enables the policy on the CPU (tests).
- ``PINT_TPU_TORCH_SOLVE_IR_RTOL``: the residual-check tolerance.
- ``PINT_TPU_TORCH_FUSED_INTERIOR``: ``0`` keeps the unfused
  ``gram32_joint`` everywhere; ``force`` routes the CPU through the fused
  dispatcher too, which there takes the kernel's plain version.
- ``PINT_TPU_TORCH_STREAM_DRIFT_RTOL``: the streaming solver's drift
  check (:func:`stream_drift_rtol`).

The equilibrated f32 factor of every refined solve is chosen by its size
(:func:`ir_cholesky`): the native ``torch.linalg.cholesky_ex``
(``ops/ffgram.py::nan_cholesky``) below :data:`IR_BLOCKED_MIN`, the blocked
``parallel/dense.py::fast_cholesky32`` at or above it.  The reference
hands operands of 2048 or more rows to the blocked factor, a speed
choice for the TPU.  On an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py`` phase 11) the native f32 factor of the dense step's
equilibrated covariance took 9.66, 46.1 and 296 ms at n = 8192, 16384
and 32768, ``fast_cholesky32`` 15.1, 79.1 and 507 ms: no crossover up
to 32768, so :data:`IR_BLOCKED_MIN` is None and every size takes the
native factor (the smoke script checks the route against its own
timings each run).  Either factor serves only as the preconditioner of
the f64-refined solve, whose residual check stays armed, so the result
keeps the reference's contract.
"""

from __future__ import annotations

import contextlib
import os
import threading

#: smallest equilibrated operand whose refined solve factors with the
#: blocked ``fast_cholesky32``; None: the native factor at every size
IR_BLOCKED_MIN: int | None = None

#: default relative residual-check tolerance: a converged refinement sits
#: at the ~1e-7 split-matmul floor, a stalled one at O(1)
DEFAULT_CHECK_RTOL = 1e-5


def _device_type(device) -> str:
    return getattr(device, "type", str(device))


def ir_setting() -> str:
    return os.environ.get("PINT_TPU_TORCH_SOLVE_IR", "1").strip().lower()


def ir_active(device) -> bool:
    """Whether the refined solve policy applies on ``device``."""
    s = ir_setting()
    if s in ("0", "off", "false", ""):
        return False
    if s == "force":
        return True
    return _device_type(device) == "cuda"


def check_rtol(device) -> float | None:
    """Residual-check tolerance when the policy is active, else None."""
    if not ir_active(device):
        return None
    return float(
        os.environ.get("PINT_TPU_TORCH_SOLVE_IR_RTOL",
                       str(DEFAULT_CHECK_RTOL))
    )


def ir_cholesky(n: int, device):
    """The equilibrated-f32 factorization of an (n, n) refined solve on
    ``device``: None (the native factor inside ``chol_solve_ir`` and
    ``woodbury_chol_solve_ir``) below :data:`IR_BLOCKED_MIN` or when the
    policy is off, ``fast_cholesky32`` at or above it."""
    if (not ir_active(device) or IR_BLOCKED_MIN is None
            or n < IR_BLOCKED_MIN):
        return None
    from pint_tpu_torch.parallel.dense import fast_cholesky32

    return fast_cholesky32


#: default residual-check tolerance of the streaming solves: a maintained
#: factor carries update roundoff, so the check is armed on every device
DEFAULT_STREAM_RTOL = 1e-5


def stream_factor_dtype(device):
    """dtype of the streaming solver's maintained Cholesky factor
    (``ops/cholupdate.py``): equilibrated f32 with f64 refinement where
    the refined-solve policy applies (the card), f64 elsewhere; the same
    ``PINT_TPU_TORCH_SOLVE_IR`` switch (``0`` keeps f64 everywhere,
    ``force`` takes f32 on the CPU)."""
    import torch

    return torch.float32 if ir_active(device) else torch.float64


def stream_drift_rtol() -> float:
    """Residual-check tolerance of the streaming drift guard
    (``PINT_TPU_TORCH_STREAM_DRIFT_RTOL``), armed on every device: both
    streaming solves NaN-poison past it and the solve returns its input
    state."""
    return float(os.environ.get("PINT_TPU_TORCH_STREAM_DRIFT_RTOL",
                                str(DEFAULT_STREAM_RTOL)))


def fused_interior_setting() -> str:
    return os.environ.get(
        "PINT_TPU_TORCH_FUSED_INTERIOR", "1"
    ).strip().lower()


_fused_bypass = threading.local()


@contextlib.contextmanager
def fused_interior_bypass():
    """Context that pins the unfused Gram regardless of the knob.
    Per-thread and re-entrant."""
    prev = getattr(_fused_bypass, "on", 0)
    _fused_bypass.on = prev + 1
    try:
        yield
    finally:
        _fused_bypass.on = prev


def fused_interior_active(device) -> bool:
    """Whether the mixed GLS step routes its joint Gram through
    ops/fused_gram.py::fused_gram_joint."""
    if getattr(_fused_bypass, "on", 0):
        return False
    s = fused_interior_setting()
    if s in ("0", "off", "false", ""):
        return False
    if s == "force":
        return True
    return _device_type(device) == "cuda"
