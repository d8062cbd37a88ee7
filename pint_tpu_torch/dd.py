"""Double-double (dd) float64 arithmetic on tensors (pint_tpu dd.py).

A dd is an unevaluated sum ``hi + lo`` of two float64 tensors with
``|lo| <= ulp(hi) / 2``, ~32 significant digits: the classical
error-free transformations (Dekker 1971, Knuth TAOCP v2, Shewchuk 1997)
as the QD library of Hida, Li & Bailey (2000) uses them.  The port's
precision-critical phase product is the exact int64 fixed point of
:mod:`pint_tpu_torch.fixedpoint`; dd is the longdouble stand-in for host
oracles and tests.

Every function is a chain of separate elementwise operations, each
rounded once, on the CPU and on CUDA alike (H100 float64 is IEEE).  A
fused multiply-add would break :func:`split` and :func:`two_prod`'s
error terms, so nothing here may be fused: no ``torch.compile``, no
``addcmul``/``lerp``/``addmm``.  ``from_longdouble``/``to_longdouble``
run in numpy on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Dekker splitter for 53-bit significands: 2^27 + 1.
_SPLITTER = 134217729.0


def _f64(x, like=None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.float64)
    dev = like.device if torch.is_tensor(like) else None
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


class DD(NamedTuple):
    """A double-double number: value = hi + lo (unevaluated,
    non-overlapping)."""

    hi: torch.Tensor
    lo: torch.Tensor

    def __add__(self, other):
        return add(self, _as_dd(other, self.hi))

    def __radd__(self, other):
        return add(_as_dd(other, self.hi), self)

    def __sub__(self, other):
        return sub(self, _as_dd(other, self.hi))

    def __rsub__(self, other):
        return sub(_as_dd(other, self.hi), self)

    def __mul__(self, other):
        return mul(self, _as_dd(other, self.hi))

    def __rmul__(self, other):
        return mul(_as_dd(other, self.hi), self)

    def __truediv__(self, other):
        return div(self, _as_dd(other, self.hi))

    def __rtruediv__(self, other):
        return div(_as_dd(other, self.hi), self)

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


def _as_dd(x, like=None) -> DD:
    if isinstance(x, DD):
        return x
    return from_f64(x, like)


# --- Error-free transformations --------------------------------------------


def two_sum(a, b):
    """s, err such that s = fl(a+b) and a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (Dekker); cheaper, same guarantee."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Split a float64 into 26+27-bit halves hi+lo = a exactly (Dekker)."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p, err such that p = fl(a*b) and a*b = p + err exactly (Dekker)."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# --- Construction / normalization ------------------------------------------


def from_f64(x, like=None) -> DD:
    """Promote a float64 tensor (or python scalar, on ``like``'s device)
    to dd with lo = 0."""
    x = _f64(x, like)
    return DD(x, torch.zeros_like(x))


def from_sum(a, b) -> DD:
    """dd representing a + b exactly, for arbitrary float64 a, b."""
    a = _f64(a, b)
    s, e = two_sum(a, _f64(b, a))
    return DD(s, e)


def normalize(hi, lo) -> DD:
    """Renormalize an (hi, lo) pair into canonical non-overlapping form."""
    s, e = quick_two_sum(hi, lo)
    return DD(s, e)


def to_f64(x: DD):
    return x.hi + x.lo


# --- Arithmetic -------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    """Accurate dd + dd (IEEE-style add from the QD library)."""
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return normalize(s1, s2)


def add_f64(x: DD, y) -> DD:
    y = _f64(y, x.hi)
    s1, s2 = two_sum(x.hi, y)
    s2 = s2 + x.lo
    return normalize(s1, s2)


def sub(x: DD, y: DD) -> DD:
    return add(x, DD(-y.hi, -y.lo))


def sub_f64(x: DD, y) -> DD:
    return add_f64(x, -_f64(y, x.hi))


def mul(x: DD, y: DD) -> DD:
    p1, p2 = two_prod(x.hi, y.hi)
    p2 = p2 + (x.hi * y.lo + x.lo * y.hi)
    return normalize(p1, p2)


def mul_f64(x: DD, y) -> DD:
    y = _f64(y, x.hi)
    p1, p2 = two_prod(x.hi, y)
    p2 = p2 + x.lo * y
    return normalize(p1, p2)


def div(x: DD, y: DD) -> DD:
    """dd / dd by long division with one Newton correction."""
    q1 = x.hi / y.hi
    r = sub(x, mul_f64(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f64(y, q2))
    q3 = r.hi / y.hi
    q, e = quick_two_sum(q1, q2)
    return add_f64(DD(q, e), q3)


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def abs_(x: DD) -> DD:
    s = torch.where(x.hi < 0, -1.0, 1.0).to(x.hi.dtype)
    return DD(x.hi * s, x.lo * s)


def sqr(x: DD) -> DD:
    p1, p2 = two_prod(x.hi, x.hi)
    p2 = p2 + 2.0 * (x.hi * x.lo)
    return normalize(p1, p2)


# --- Comparisons (on canonical dds, hi dominates; ties broken by lo) --------


def lt(x: DD, y: DD):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def le(x: DD, y: DD):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo <= y.lo))


def gt(x: DD, y: DD):
    return lt(y, x)


def ge(x: DD, y: DD):
    return le(y, x)


# --- Rounding / phase splitting ---------------------------------------------


def round_nearest(x: DD):
    """Nearest integer to a dd, as float64, with the dd tie/carry
    handled: the fractional part stays in [-0.5, 0.5)."""
    n = torch.round(x.hi)
    frac = add_f64(x, -n)
    # carry decisions must see the full dd (hi exactly +/-0.5 with a
    # compensating lo is reachable and flips the nearest integer)
    up = (frac.hi > 0.5) | ((frac.hi == 0.5) & (frac.lo >= 0.0))
    dn = (frac.hi < -0.5) | ((frac.hi == -0.5) & (frac.lo < 0.0))
    n = torch.where(up, n + 1.0, n)
    n = torch.where(dn, n - 1.0, n)
    return n


def split_int_frac(x: DD):
    """(integer part as float64, fractional dd in [-0.5, 0.5))."""
    n = round_nearest(x)
    return n, add_f64(x, -n)


def floor_(x: DD):
    """Floor of a dd as float64 (exact for |x| < 2^52)."""
    n = torch.floor(x.hi)
    r = add_f64(x, -n)
    n = torch.where(r.hi >= 1.0, n + 1.0, n)
    n = torch.where(r.hi < 0.0, n - 1.0, n)
    return n


# --- Polynomial evaluation ---------------------------------------------------


def horner(x: DD, coeffs) -> DD:
    """sum_k coeffs[k] x^k in dd by Horner's rule; ``coeffs`` DD or
    float64 scalars, lowest order first."""
    acc = _as_dd(coeffs[-1], x.hi)
    for c in reversed(coeffs[:-1]):
        acc = add(mul(acc, x), _as_dd(c, x.hi))
    return acc


def taylor_horner(x: DD, coeffs) -> DD:
    """sum_k coeffs[k] x^k / k! (the reference's taylor_horner)."""
    fact = 1.0
    scaled = []
    for k, c in enumerate(coeffs):
        if k > 0:
            fact *= k
        # divide in dd: 1.0/fact is inexact in f64 for k >= 3 and would
        # cap the term at ~1e-16 relative; fact itself is exact < 2^53
        scaled.append(div(_as_dd(c, x.hi), from_f64(fact, x.hi)))
    return horner(x, scaled)


# --- Host-side exact construction -------------------------------------------


def from_longdouble(x, device=None) -> DD:
    """Split numpy longdouble(s) into an exact dd pair (host numpy,
    then onto ``device``)."""
    x = np.asarray(x, dtype=np.longdouble)
    hi = x.astype(np.float64)
    lo = (x - hi.astype(np.longdouble)).astype(np.float64)
    return DD(torch.as_tensor(hi, device=device),
              torch.as_tensor(lo, device=device))


def to_longdouble(x: DD):
    """Recombine a dd into numpy longdouble on the host."""
    return (np.asarray(x.hi.cpu().numpy(), dtype=np.longdouble)
            + np.asarray(x.lo.cpu().numpy(), dtype=np.longdouble))
