"""Double-double (DD) arithmetic on pairs of float64 tensors.

A DD value represents x = hi + lo with |lo| <= ulp(hi)/2, about 32
significant digits: pulse phase over decades needs ~1e-19 relative
precision, beyond float64.  The algorithms are the classical error-free
transforms (Dekker 1971, Knuth TAOCP v2, Hida-Li-Bailey QD): two_sum,
split/two_prod, renormalization.  Counterpart of ``pint_tpu/ops/dd.py``.

Evaluation order is load-bearing.  Every transform needs each product and
sum rounded to float64 exactly where it is written: contracting
``a*b - p`` into one fused multiply-add, or reassociating
``a - (s - bb)``, silently destroys the error term (the JAX package
records phase error growing from 1e-24 s to 1e-8 s when its compiler was
allowed to rewrite these).  Eager PyTorch runs each operator as its own
kernel with its own rounding, so nothing contracts or reassociates here.
Keep it that way: never run this module under ``torch.compile``, and
never move a DD routine into a Triton or CUDA kernel unless that kernel is
built with floating-point contraction off (``nvcc --fmad=false``).

Derivatives: ``torch.func.jacfwd`` of the phase kernel is the design
matrix.  Differentiating through the error-free transforms would give
noisy tangents, so each core operation is a ``torch.autograd.Function``
whose primal is the exact transform and whose tangent is the plain-f64
derivative of hi + lo, carried as the pair (t, 0) — the custom JVPs of
the JAX package.  ``generate_vmap_rule`` lets ``jacfwd`` batch them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SPLITTER = 134217729.0  # 2**27 + 1
F64 = torch.float64


def _two_sum(a, b):
    """s + err == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Like two_sum but requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Dekker split: a = hi + lo with hi, lo having <= 27 significant bits."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    """p + err == a * b exactly, p = fl(a*b)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _add_raw(ahi, alo, bhi, blo):
    s, e = _two_sum(ahi, bhi)
    e = e + (alo + blo)
    return _quick_two_sum(s, e)


def _mul_raw(ahi, alo, bhi, blo):
    p, e = _two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return _quick_two_sum(p, e)


def _div_raw(ahi, alo, bhi, blo):
    # three-step long division (the classic dd_real algorithm): each
    # partial quotient is the f64 quotient of the running remainder
    q1 = ahi / bhi
    phi, plo = _mul_raw(bhi, blo, q1, torch.zeros_like(q1))
    rhi, rlo = _add_raw(ahi, alo, -phi, -plo)
    q2 = rhi / bhi
    phi, plo = _mul_raw(bhi, blo, q2, torch.zeros_like(q2))
    rhi, rlo = _add_raw(rhi, rlo, -phi, -plo)
    q3 = rhi / bhi
    s, e = _quick_two_sum(q1, q2)
    return _quick_two_sum(s, e + q3)


def _t(x, like=None):
    """float64 tensor on ``like``'s device.  A Python scalar becomes a
    ``torch.full`` (a fill kernel, never a host-to-device copy, which
    would wait for the card's queue)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == F64 else x.to(F64)
    if isinstance(x, (int, float)):
        dev = like.device if isinstance(like, torch.Tensor) else None
        return torch.full((), float(x), dtype=F64, device=dev)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=F64, device=dev)


def _z(t):
    return 0.0 if t is None else t


def _tangent_pair(t, ctx):
    """The DD tangent (t, 0), broadcast to the output's shape."""
    if not isinstance(t, torch.Tensor):  # every input tangent was absent
        t = torch.full((), float(t), dtype=F64, device=ctx.device)
    t = torch.broadcast_to(t, ctx.shape)
    return t, torch.zeros_like(t)


class _AddCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(ahi, alo, bhi, blo):
        return _add_raw(ahi, alo, bhi, blo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, tahi, talo, tbhi, tblo):
        t = (_z(tahi) + _z(talo)) + (_z(tbhi) + _z(tblo))
        return _tangent_pair(t, ctx)


class _MulCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(ahi, alo, bhi, blo):
        return _mul_raw(ahi, alo, bhi, blo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, tahi, talo, tbhi, tblo):
        ahi, alo, bhi, blo = ctx.saved_tensors
        t = (ahi + alo) * (_z(tbhi) + _z(tblo)) + (bhi + blo) * (
            _z(tahi) + _z(talo)
        )
        return _tangent_pair(t, ctx)


class _DivCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(ahi, alo, bhi, blo):
        return _div_raw(ahi, alo, bhi, blo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _ahi, _alo, bhi, blo = inputs
        ctx.save_for_forward(bhi, blo, output[0], output[1])
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, tahi, talo, tbhi, tblo):
        bhi, blo, qhi, qlo = ctx.saved_tensors
        b = bhi + blo
        q = qhi + qlo
        t = ((_z(tahi) + _z(talo)) - q * (_z(tbhi) + _z(tblo))) / b
        return _tangent_pair(t, ctx)


class _NormCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(hi, lo):
        return _quick_two_sum(hi, lo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, thi, tlo):
        return _tangent_pair(_z(thi) + _z(tlo), ctx)


class _FromSumCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return _two_sum(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, ta, tb):
        return _tangent_pair(_z(ta) + _z(tb), ctx)


class _FromProdCore(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return _two_prod(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)
        ctx.shape, ctx.device = output[0].shape, output[0].device

    @staticmethod
    def jvp(ctx, ta, tb):
        a, b = ctx.saved_tensors
        return _tangent_pair(a * _z(tb) + b * _z(ta), ctx)


class DD(NamedTuple):
    """A double-double number (or tensor of them): value = hi + lo."""

    hi: torch.Tensor
    lo: torch.Tensor

    # -- construction ----------------------------------------------------
    @staticmethod
    def from_float(x, like=None) -> "DD":
        x = _t(x, like)
        return DD(x, torch.zeros_like(x))

    @staticmethod
    def from_sum(a, b) -> "DD":
        """DD representing a + b exactly (a, b floats)."""
        a = _t(a, b)
        b = _t(b, a)
        return DD(*_FromSumCore.apply(a, b))

    @staticmethod
    def from_prod(a, b) -> "DD":
        """DD representing a * b exactly (a, b floats)."""
        a = _t(a, b)
        b = _t(b, a)
        return DD(*_FromProdCore.apply(a, b))

    @staticmethod
    def zeros(shape, device=None) -> "DD":
        z = torch.zeros(shape, dtype=F64, device=device)
        return DD(z, z)

    def _coerce(self, other) -> "DD":
        return other if isinstance(other, DD) else DD.from_float(other, self.hi)

    # -- norm ------------------------------------------------------------
    def normalize(self) -> "DD":
        return DD(*_NormCore.apply(self.hi, self.lo))

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other) -> "DD":
        o = self._coerce(other)
        return DD(*_AddCore.apply(self.hi, self.lo, o.hi, o.lo))

    __radd__ = __add__

    def __neg__(self) -> "DD":
        return DD(-self.hi, -self.lo)

    def __sub__(self, other) -> "DD":
        return self + (-self._coerce(other))

    def __rsub__(self, other) -> "DD":
        return (-self) + other

    def __mul__(self, other) -> "DD":
        o = self._coerce(other)
        return DD(*_MulCore.apply(self.hi, self.lo, o.hi, o.lo))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "DD":
        o = self._coerce(other)
        return DD(*_DivCore.apply(self.hi, self.lo, o.hi, o.lo))

    def __rtruediv__(self, other) -> "DD":
        return DD.from_float(other, self.hi) / self

    # -- conversions -----------------------------------------------------
    def to_float(self) -> torch.Tensor:
        return self.hi + self.lo

    def split_int_frac(self):
        """(integer part as f64, fractional part in [-0.5, 0.5)).

        Carries use floor(x + 0.5), not round-half-even: ties map to
        frac == -0.5 whatever the integer part's parity."""
        ihi = torch.floor(self.hi + 0.5)
        rem = DD(self.hi - ihi, self.lo).normalize()  # hi-ihi is exact
        ilo = torch.floor(rem.hi + 0.5)
        frac = DD(rem.hi - ilo, rem.lo).normalize()
        carry = torch.floor(frac.hi + frac.lo + 0.5)
        return ihi + ilo + carry, (frac - carry).to_float()

    @property
    def shape(self):
        return self.hi.shape

    def __getitem__(self, idx) -> "DD":
        return DD(self.hi[idx], self.lo[idx])


def dd_sqrt(x: DD) -> DD:
    """DD square root via one Newton step on the f64 estimate."""
    r = torch.sqrt(x.hi)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)  # x == 0: no 0/0
    r_dd = DD.from_float(r)
    diff = x - r_dd * r_dd
    zero = torch.zeros_like(r)
    corr = DD(
        torch.where(r == 0, zero, diff.hi / (2.0 * safe_r)),
        torch.where(r == 0, zero, diff.lo / (2.0 * safe_r)),
    )
    return (r_dd + corr).normalize()


def dd_where(cond, a: DD, b: DD) -> DD:
    return DD(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))
