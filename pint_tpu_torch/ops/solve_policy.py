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

The equilibrated f32 factor of every refined solve is the native
``torch.linalg.cholesky_ex`` (``ops/ffgram.py::nan_cholesky``) at every
size.  The reference hands operands of 2048 or more rows to its blocked
``fast_cholesky32``: a speed choice for the TPU, where the native
factorization compiles slowly.  Either factor serves only as the
preconditioner of the f64-refined solve, whose residual check stays
armed, so the result keeps the reference's contract (ROADMAP A8 ports
the blocked factorization).
"""

from __future__ import annotations

import contextlib
import os
import threading

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
