"""Transcendentals for scalar model parameters, under the JAX package's names.

In ``pint_tpu/ops/scalarmath.py`` these wrappers route 0-d operands off a
scalar path that is only float32-accurate on the TPU.  CUDA and the CPU
evaluate float64 transcendentals in full precision at every rank, so here
each name is the plain torch call; the names stay so that component code
reads the same in both packages.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=F64)


def sin_p(x):
    return torch.sin(_t(x))


def cos_p(x):
    return torch.cos(_t(x))


def tan_p(x):
    return torch.tan(_t(x))


def exp_p(x):
    return torch.exp(_t(x))


def log_p(x):
    return torch.log(_t(x))


def arctan2_p(x, y):
    return torch.atan2(_t(x), _t(y))


def power_p(x, y):
    return torch.pow(_t(x), _t(y))
