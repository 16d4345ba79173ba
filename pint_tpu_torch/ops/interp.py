"""Table lookups with ``jnp.interp``'s edge behaviour, written out.

``interp`` is ``jnp.interp(x, xp, fp)`` step for step: the bracketing
index from a right-sided ``searchsorted`` clipped to [1, len - 1], the
same linear formula (a zero-width bracket takes its left value), and the
end values held flat outside [xp[0], xp[-1]].  ``nearest`` is the
reference IFunc's nearest-node rule (ties go to the right node).  Both
take host tables (numpy arrays or sequences) and per-TOA ``x`` tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = float(np.spacing(np.finfo(np.float64).eps))


@functools.cache
def _device_table(data: bytes, device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(data, dtype=np.float64).copy(),
                           device=device)


def _table(a, like):
    """The host table ``a`` on ``like``'s device, copied there once per
    distinct table and kept: a step program's graph reads it by address,
    and a copy to the card inside a captured step would wait on the
    host."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    return _device_table(a.tobytes(), like.device)


def interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, flat past the ends."""
    xp, fp = _table(xp, x), _table(fp, x)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _EPS
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def nearest(x, xs, ys):
    """ys at the node of xs nearest to x; a tie takes the right node."""
    xs, ys = _table(xs, x), _table(ys, x)
    n = xs.shape[0]
    idx = torch.clamp(torch.searchsorted(xs, x.contiguous()), 0, n - 1)
    left = torch.clamp(idx - 1, 0, n - 1)
    use_left = torch.abs(x - xs[left]) < torch.abs(x - xs[idx])
    return torch.where(use_left, ys[left], ys[idx])
