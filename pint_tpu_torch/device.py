"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card.  There is no
silent fallback: with no card present and no device given they raise, so a
run that was meant for the card can never quietly time the CPU.  Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pint_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the host explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pint_tpu_torch: device='cuda' but no CUDA device")
    return dev
