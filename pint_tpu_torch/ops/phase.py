"""Two-part pulse phase: (integer cycles, fractional cycles).

Counterpart of ``pint_tpu/ops/phase.py``: ``int_`` is an f64 tensor
holding an exact integer (|n| < 2**53) and ``frac`` an f64 tensor in
[-0.5, 0.5), so ~1e12 absolute cycles never eat the sub-ns fraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_tpu_torch.ops.dd import DD, F64, _t


class Phase(NamedTuple):
    int_: torch.Tensor  # exact integer stored as f64
    frac: torch.Tensor  # [-0.5, 0.5)

    @staticmethod
    def from_dd(x: DD) -> "Phase":
        i, f = x.split_int_frac()
        return Phase(i, f)

    @staticmethod
    def from_float(x, like=None) -> "Phase":
        x = _t(x, like)
        i = torch.floor(x + 0.5)  # ties -> frac == -0.5, parity-independent
        return Phase(i, x - i)

    @staticmethod
    def zeros(shape, device=None) -> "Phase":
        z = torch.zeros(shape, dtype=F64, device=device)
        return Phase(z, z)

    def __add__(self, other) -> "Phase":
        if not isinstance(other, Phase):
            other = Phase.from_float(other, self.frac)
        f = self.frac + other.frac
        carry = torch.floor(f + 0.5)
        return Phase(self.int_ + other.int_ + carry, f - carry)

    def __sub__(self, other) -> "Phase":
        if not isinstance(other, Phase):
            other = Phase.from_float(other, self.frac)
        return self + Phase(-other.int_, -other.frac)

    def __neg__(self) -> "Phase":
        return Phase(-self.int_, -self.frac)

    def to_float(self) -> torch.Tensor:
        """Total phase as f64 (loses sub-cycle precision at large N)."""
        return self.int_ + self.frac

    def to_dd(self) -> DD:
        return DD.from_sum(self.int_, self.frac)

    @property
    def shape(self):
        return self.int_.shape

    def __getitem__(self, idx) -> "Phase":
        return Phase(self.int_[idx], self.frac[idx])
