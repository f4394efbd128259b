"""Double-float (pair) arithmetic on torch tensors.

A port of ``acme_tpu/ops/dfmath.py``: every value is an unevaluated
(hi, lo) float32 pair built from error-free transforms (TwoSum, Dekker
TwoProd), carrying ~48 bits of significand.  :class:`DF` mimics enough of
the tensor surface that the element library's ``fn(xp, q)`` physics runs
unchanged with ``xp = acme_tpu_torch.ops.dfmath`` and ``q`` a :class:`DF`.

Everything here is +, -, *, /, sqrt and comparisons on float32 tensors,
in the same order as the JAX module, so on the CPU the results equal
``acme_tpu.ops.dfmath`` bit for bit.  This is the plain version of the
kernel's ``csrc/df.cuh``, which forms TwoProd's error with one fused
multiply-add instead of the Dekker split (both are exact, so the pairs
agree wherever the split does not overflow, i.e. |a| < 8.3e34).
"""

from __future__ import annotations

import math

import numpy as np
import torch

float32 = torch.float32


def _exp2_exact(k):
    """Exact 2**k for integer-valued float32 k in [-126, 126] (bit-level)."""
    ki = torch.clamp(k, -126.0, 126.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


# -- error-free transforms ---------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    # |a| must stay below 2^126/4097 (~8.3e34); see acme_tpu.ops.dfmath
    c = 4097.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _renorm(hi, lo):
    return _quick_two_sum(hi, lo)


def _const(c):
    """Split a Python float into an exact (hi, lo) float32 pair."""
    hi = np.float32(c)
    lo = np.float32(float(c) - float(hi))
    return float(hi), float(lo)


# -- the DF pair -------------------------------------------------------------

class DF:
    """A tensor of double-floats: two float32 tensors (hi, lo) with value
    hi + lo, |lo| <= ulp(hi)/2."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = hi
        self.lo = torch.zeros_like(hi) if lo is None else lo

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def ndim(self):
        return self.hi.ndim

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])

    def value(self):
        """Collapse to a single float32 tensor."""
        return self.hi + self.lo

    def _coerce(self, other):
        if isinstance(other, DF):
            return other
        if isinstance(other, (int, float)):
            hi, lo = _const(other)
            z = torch.zeros_like(self.hi)
            return DF(z + hi, z + lo)
        return DF(other.to(self.hi.dtype))

    def __add__(self, other):
        o = self._coerce(other)
        s, e = _two_sum(self.hi, o.hi)
        e = e + (self.lo + o.lo)
        return DF(*_renorm(s, e))

    __radd__ = __add__

    def __neg__(self):
        return DF(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = self._coerce(other)
        p, e = _two_prod(self.hi, o.hi)
        e = e + (self.hi * o.lo + self.lo * o.hi)
        return DF(*_renorm(p, e))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        q0 = self.hi / o.hi
        p, e = _two_prod(q0, o.hi)
        r = ((self.hi - p) - e) + self.lo - q0 * o.lo
        return DF(*_renorm(q0, r / o.hi))

    def __rtruediv__(self, other):
        return self._coerce(other) / self

    def __pow__(self, n):
        if not isinstance(n, int) or n < 0:
            raise NotImplementedError("DF.__pow__ supports non-negative ints")
        out = None
        base = self
        k = n
        while k:
            if k & 1:
                out = base if out is None else out * base
            base = base * base
            k >>= 1
        if out is None:
            return DF(torch.ones_like(self.hi))
        return out

    # comparisons decide branches: the collapsed value is plenty
    def __lt__(self, other):
        o = self._coerce(other)
        return (self.hi + self.lo) < (o.hi + o.lo)

    def __le__(self, other):
        o = self._coerce(other)
        return (self.hi + self.lo) <= (o.hi + o.lo)

    def __gt__(self, other):
        o = self._coerce(other)
        return (self.hi + self.lo) > (o.hi + o.lo)

    def __ge__(self, other):
        o = self._coerce(other)
        return (self.hi + self.lo) >= (o.hi + o.lo)

    def __repr__(self):
        return f"DF(hi={self.hi!r}, lo={self.lo!r})"


def _as_df(x, like=None):
    if isinstance(x, DF):
        return x
    if isinstance(x, (int, float)) and like is not None:
        hi, lo = _const(x)
        z = torch.zeros_like(like.hi)
        return DF(z + hi, z + lo)
    return DF(torch.as_tensor(x, dtype=float32))


# -- namespace functions (the xp surface of the element library) -------------

def stack(parts, axis=0):
    like = next((p for p in parts if isinstance(p, DF)), None)
    parts = [_as_df(p, like) for p in parts]
    return DF(torch.stack([p.hi for p in parts], dim=axis),
              torch.stack([p.lo for p in parts], dim=axis))


def concatenate(parts, axis=0):
    parts = [_as_df(p) for p in parts]
    return DF(torch.cat([p.hi for p in parts], dim=axis),
              torch.cat([p.lo for p in parts], dim=axis))


def zeros(shape, dtype=float32):
    z = torch.zeros(tuple(shape), dtype=float32)
    return DF(z, z)


def zeros_like(x):
    z = torch.zeros_like(x.hi if isinstance(x, DF) else x)
    return DF(z, z)


def ones_like(x):
    h = x.hi if isinstance(x, DF) else x
    return DF(torch.ones_like(h), torch.zeros_like(h))


def full_like(x, v):
    h = x.hi if isinstance(x, DF) else x
    hi, lo = _const(float(v))
    return DF(torch.full_like(h, hi), torch.full_like(h, lo))


def where(c, a, b):
    if not isinstance(a, DF) and not isinstance(b, DF):
        return torch.where(c, a, b)
    like = a if isinstance(a, DF) else b
    a = _as_df(a, like)
    b = _as_df(b, like)
    return DF(torch.where(c, a.hi, b.hi), torch.where(c, a.lo, b.lo))


def sign(x):
    if isinstance(x, DF):
        return DF(torch.sign(x.hi + x.lo))
    return torch.sign(x)


def abs(x):  # noqa: A001 - mirrors the numpy namespace
    if isinstance(x, DF):
        neg = (x.hi + x.lo) < 0
        return DF(torch.where(neg, -x.hi, x.hi), torch.where(neg, -x.lo, x.lo))
    return torch.abs(x)


def minimum(a, b):
    if isinstance(a, DF) or isinstance(b, DF):
        like = a if isinstance(a, DF) else b
        a = _as_df(a, like)
        b = _as_df(b, like)
        take_a = (a.hi + a.lo) <= (b.hi + b.lo)
        return DF(torch.where(take_a, a.hi, b.hi),
                  torch.where(take_a, a.lo, b.lo))
    return torch.minimum(a, b)


def maximum(a, b):
    if isinstance(a, DF) or isinstance(b, DF):
        like = a if isinstance(a, DF) else b
        a = _as_df(a, like)
        b = _as_df(b, like)
        take_a = (a.hi + a.lo) >= (b.hi + b.lo)
        return DF(torch.where(take_a, a.hi, b.hi),
                  torch.where(take_a, a.lo, b.lo))
    return torch.maximum(a, b)


def logical_and(a, b):
    return torch.logical_and(a, b)


def logical_not(a):
    return torch.logical_not(a)


def isfinite(x):
    if isinstance(x, DF):
        return torch.isfinite(x.hi) & torch.isfinite(x.lo)
    return torch.isfinite(x)


# -- transcendentals ---------------------------------------------------------

_LN2 = _const(0.6931471805599453)
_INV_LN2 = 1.4426950408889634
# Taylor 1/k! for exp on |r| <= ln2/2 (degree 12: tail below 2e-16)
_EXP_COEFFS = [_const(1.0 / math.factorial(k)) for k in range(13)]


def _poly_exp(r):
    """exp(r) for |r| <= ln2/2, in df (Horner with split f64 coefficients)."""
    acc = DF(torch.zeros_like(r.hi) + _EXP_COEFFS[-1][0],
             torch.zeros_like(r.hi) + _EXP_COEFFS[-1][1])
    for c_hi, c_lo in reversed(_EXP_COEFFS[:-1]):
        acc = acc * r
        s, e = _two_sum(acc.hi, c_hi)
        acc = DF(*_renorm(s, e + (acc.lo + c_lo)))
    return acc


def _exp_reduced(x):
    """Range-reduce and return (exp(r) df, k) with x = k ln2 + r."""
    xv = x.hi + x.lo
    k = torch.round(xv * _INV_LN2)
    p1, e1 = _two_prod(k, torch.full_like(k, _LN2[0]))
    r_hi, r_e = _two_sum(x.hi, -p1)
    r_lo = r_e + x.lo - e1 - k * _LN2[1]
    r = DF(*_renorm(r_hi, r_lo))
    return _poly_exp(r), k


def exp(x):
    if not isinstance(x, DF):
        return torch.exp(x)
    xc = minimum(x, 87.0)
    xc = maximum(xc, -87.0)
    p, k = _exp_reduced(xc)
    s = _exp2_exact(k)
    return DF(p.hi * s, p.lo * s)


def expm1(x):
    if not isinstance(x, DF):
        return torch.expm1(x)
    xc = minimum(x, 87.0)
    xc = maximum(xc, -87.0)
    p, k = _exp_reduced(xc)
    s = _exp2_exact(k)
    scaled = DF(*_renorm(p.hi * s, p.lo * s))
    big = scaled - 1.0
    small = DF(*_renorm(p.hi - 1.0, p.lo))
    return where(k == 0, small, big)


def tanh(x):
    if not isinstance(x, DF):
        return torch.tanh(x)
    a = abs(x)
    em = expm1(DF(-2.0 * a.hi, -2.0 * a.lo))
    t = (-em) / (em + 2.0)
    sgn = torch.sign(x.hi + x.lo)
    return DF(t.hi * sgn, t.lo * sgn)


def _sqrt32(x):
    """Correctly rounded float32 sqrt (torch's CPU kernel is not, in a few
    ulp-boundary cases; the kernel's sqrtf is): the float64 root rounds
    to the correct float32 one."""
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == float32 \
        else torch.sqrt(x)


def sqrt(x):
    if not isinstance(x, DF):
        return _sqrt32(x)
    s = _sqrt32(x.hi)
    p, e = _two_prod(s, s)
    r = ((x.hi - p) - e) + x.lo
    corr = torch.where(s > 0, r / torch.where(s > 0, 2.0 * s, 1.0),
                       torch.zeros_like(s))
    return DF(*_renorm(s, corr))
