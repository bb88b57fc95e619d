"""Interval lattice for the scale-safety abstract interpreter; port of
``repro/staticcheck/lattice.py``.

The domain is a single product lattice value per traced tensor:

    Ival(lo, hi, known)

``lo``/``hi`` bound every element of the tensor with exact Python numbers
(unbounded ints, or floats including ``±inf``); ``known=False`` marks a
value whose bounds are a *fallback* (unmodelled op, kernel output) — such
values still flow, but never fire findings, so the analyzer stays sound
against false positives at the cost of false negatives.

Everything here is pure Python on scalars, bit for bit the reference's
arithmetic, so the transfer functions are unit-testable against
brute-force enumeration over tiny concrete ranges and against the
reference itself (``tests/test_torch_absint.py``).

The dtype helpers take ``torch.dtype`` and capture the two facts the
W-rules need:

* integer range + signedness (``int_bounds`` / ``is_signed_int``) — W1
  fires when a *signed* interval escapes its dtype; unsigned arithmetic
  wraps (two's-complement semantics, see ``wrap_unsigned``);
* float mantissa width (``mantissa_bits`` / ``ulp_at``) — W2 fires when
  a quantizing op sees magnitudes at which the ulp spacing exceeds 1
  (the ``round(BIG/L)*L == BIG`` min-image collapse).

The reference reads a dtype's name (``"int32"``); ``str(torch.int32)`` is
``"torch.int32"``, so the port maps torch dtypes explicitly.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Ival",
    "TOP",
    "const",
    "join",
    "meet",
    "add",
    "sub",
    "mul",
    "div",
    "rem",
    "neg",
    "iabs",
    "imin",
    "imax",
    "floor_op",
    "ceil_op",
    "round_op",
    "truncate",
    "bit_and",
    "bit_or",
    "bit_xor",
    "shift_left",
    "shift_right",
    "scale_by_count",
    "monotonic",
    "int_bounds",
    "is_signed_int",
    "is_unsigned_int",
    "is_float",
    "mantissa_bits",
    "ulp_at",
    "wrap_unsigned",
    "dtype_top",
]


@dataclasses.dataclass(frozen=True)
class Ival:
    """Bounds on every element of one traced array. Exact Python numbers;
    ``known=False`` means the bounds are a fallback and must not fire
    findings."""
    lo: float
    hi: float
    known: bool = True

    def __post_init__(self):
        assert self.lo <= self.hi, (self.lo, self.hi)

    def contains(self, x) -> bool:
        return self.lo <= x <= self.hi

    def overlaps(self, other: "Ival") -> bool:
        return self.lo <= other.hi and other.lo <= self.hi

    def maxmag(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    def is_point(self) -> bool:
        return self.lo == self.hi


TOP = Ival(-math.inf, math.inf, known=False)


def const(x) -> Ival:
    x = float(x) if isinstance(x, float) else x
    return Ival(x, x, known=True)


def join(a: Ival, b: Ival) -> Ival:
    return Ival(min(a.lo, b.lo), max(a.hi, b.hi), a.known and b.known)


def meet(a: Ival, b: Ival):
    """Intersection, or None when empty (an infeasible refinement branch)."""
    lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
    if lo > hi:
        return None
    return Ival(lo, hi, a.known and b.known)


def _k(*ivals: Ival) -> bool:
    return all(v.known for v in ivals)


def add(a: Ival, b: Ival) -> Ival:
    return Ival(a.lo + b.lo, a.hi + b.hi, _k(a, b))


def sub(a: Ival, b: Ival) -> Ival:
    return Ival(a.lo - b.hi, a.hi - b.lo, _k(a, b))


def _mul1(x, y):
    if (x == 0 or y == 0):
        return 0
    if math.isinf(x) or math.isinf(y):
        return math.inf if (x > 0) == (y > 0) else -math.inf
    return x * y


def mul(a: Ival, b: Ival) -> Ival:
    cs = [_mul1(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Ival(min(cs), max(cs), _k(a, b))


def div(a: Ival, b: Ival) -> Ival:
    """Quotient bounds; a denominator interval containing 0 yields
    unbounded (but still *known*) magnitude."""
    if b.lo <= 0 <= b.hi:
        return Ival(-math.inf, math.inf, _k(a, b))
    cs = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            cs.append(-math.inf if math.isinf(x) and x < 0 else
                      math.inf if math.isinf(x) else x / y)
    return Ival(min(cs), max(cs), _k(a, b))


def rem(a: Ival, b: Ival) -> Ival:
    """|a % b| < max|b|, sign follows the dividend (C semantics: torch.fmod;
    ``torch.remainder`` follows the divisor)."""
    m = b.maxmag()
    if math.isinf(m):
        return Ival(-math.inf, math.inf, _k(a, b))
    lo = -m if a.lo < 0 else 0
    hi = m if a.hi > 0 else 0
    # |r| <= |a|, so the dividend clamps the bound on ITS side of zero
    # only (an all-negative dividend still admits r == 0: -6 % -2 == 0).
    if a.lo <= 0 and not math.isinf(a.lo):
        lo = max(lo, a.lo)
    if a.hi >= 0 and not math.isinf(a.hi):
        hi = min(hi, a.hi)
    return Ival(lo, hi, _k(a, b))


def neg(a: Ival) -> Ival:
    return Ival(-a.hi, -a.lo, a.known)


def iabs(a: Ival) -> Ival:
    if a.lo >= 0:
        return a
    if a.hi <= 0:
        return neg(a)
    return Ival(0, max(-a.lo, a.hi), a.known)


def imin(a: Ival, b: Ival) -> Ival:
    return Ival(min(a.lo, b.lo), min(a.hi, b.hi), _k(a, b))


def imax(a: Ival, b: Ival) -> Ival:
    return Ival(max(a.lo, b.lo), max(a.hi, b.hi), _k(a, b))


def floor_op(a: Ival) -> Ival:
    return Ival(_floor(a.lo), _floor(a.hi), a.known)


def ceil_op(a: Ival) -> Ival:
    return Ival(_ceil(a.lo), _ceil(a.hi), a.known)


def round_op(a: Ival) -> Ival:
    return Ival(_floor(a.lo), _ceil(a.hi), a.known)


def truncate(a: Ival) -> Ival:
    """Round-toward-zero (float→int convert semantics)."""
    lo = _ceil(a.lo) if a.lo < 0 else _floor(a.lo)
    hi = _ceil(a.hi) if a.hi < 0 else _floor(a.hi)
    return Ival(lo, hi, a.known)


def _floor(x):
    return x if math.isinf(x) else math.floor(x)


def _ceil(x):
    return x if math.isinf(x) else math.ceil(x)


def _pow2_cover(hi) -> float:
    """Smallest 2^k - 1 >= hi (bound for bitwise or/xor of nonnegatives)."""
    if math.isinf(hi):
        return math.inf
    return (1 << max(int(hi), 0).bit_length()) - 1


def bit_and(a: Ival, b: Ival) -> Ival:
    """x & mask with a nonnegative mask lands in [0, mask] regardless of
    the sign of x (two's complement) — the mask-recovery rule that keeps
    Morton bit-surgery precise."""
    if b.lo >= 0 and not math.isinf(b.hi):
        hi = b.hi if a.lo < 0 or math.isinf(a.hi) else min(a.hi, b.hi)
        return Ival(0, hi, _k(a, b) if a.known or b.known else False)
    if a.lo >= 0 and not math.isinf(a.hi):
        return bit_and(b, a)
    return Ival(-math.inf, math.inf, False)


def bit_or(a: Ival, b: Ival) -> Ival:
    if a.lo >= 0 and b.lo >= 0:
        return Ival(0, _pow2_cover(max(a.hi, b.hi)), _k(a, b))
    return Ival(-math.inf, math.inf, False)


def bit_xor(a: Ival, b: Ival) -> Ival:
    if a.lo >= 0 and b.lo >= 0:
        return Ival(0, _pow2_cover(max(a.hi, b.hi)), _k(a, b))
    return Ival(-math.inf, math.inf, False)


def shift_left(a: Ival, s: Ival) -> Ival:
    if s.lo < 0 or math.isinf(s.hi):
        return Ival(-math.inf, math.inf, False)
    cs = [_mul1(x, 1 << int(k)) for x in (a.lo, a.hi)
          for k in (s.lo, s.hi)]
    return Ival(min(cs), max(cs), _k(a, s))


def shift_right(a: Ival, s: Ival, *, arithmetic: bool) -> Ival:
    if s.lo < 0 or math.isinf(s.hi) or math.isinf(a.maxmag()):
        return Ival(-math.inf, math.inf, False)
    if not arithmetic and a.lo < 0:
        # logical shift of a negative reinterprets the sign bit: huge.
        return Ival(-math.inf, math.inf, False)
    cs = [x >> int(k) if isinstance(x, int) else math.floor(x / (1 << int(k)))
          for x in (int(a.lo), int(a.hi)) for k in (s.lo, s.hi)]
    return Ival(min(cs), max(cs), _k(a, s))


def scale_by_count(a: Ival, count, known: bool = True) -> Ival:
    """Bounds on a sum of ``count`` terms each in ``a`` (reduce_sum,
    cumsum, psum, scatter-add accumulation)."""
    lo = _mul1(min(a.lo, 0), count)
    hi = _mul1(max(a.hi, 0), count)
    return Ival(lo, hi, a.known and known)


def monotonic(a: Ival, f) -> Ival:
    """Transfer for a monotonically increasing scalar function."""
    return Ival(f(a.lo), f(a.hi), a.known)


# --- dtype facts -------------------------------------------------------------

# bits of each integer dtype, signed and unsigned
_SIGNED = {torch.int8: 8, torch.int16: 16, torch.int32: 32, torch.int64: 64}
_UNSIGNED = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32,
             torch.uint64: 64}
# mantissa width incl. the implicit bit
_MANTISSA = {torch.float16: 11, torch.bfloat16: 8, torch.float32: 24,
             torch.float64: 53}


def is_signed_int(dtype) -> bool:
    return dtype in _SIGNED


def is_unsigned_int(dtype) -> bool:
    return dtype in _UNSIGNED


def is_float(dtype) -> bool:
    return dtype in _MANTISSA


def int_bounds(dtype):
    """(min, max) representable for an integer dtype; None otherwise."""
    if dtype in _UNSIGNED:
        return 0, (1 << _UNSIGNED[dtype]) - 1
    bits = _SIGNED.get(dtype)
    if bits is None:
        return None
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def mantissa_bits(dtype):
    """Mantissa width incl. the implicit bit; None for non-floats. Integer
    spacing is exact up to 2^mantissa_bits (2^24 for f32, 2^53 for f64)."""
    return _MANTISSA.get(dtype)


def ulp_at(mag: float, dtype) -> float:
    """Spacing between representable floats at magnitude ``mag``."""
    m = mantissa_bits(dtype)
    if m is None or mag == 0:
        return 0.0
    if math.isinf(mag):
        return math.inf
    return 2.0 ** (math.floor(math.log2(abs(mag))) + 1 - m)


def wrap_unsigned(v: Ival, dtype) -> Ival:
    """Two's-complement wrap of an unsigned result: if the true interval
    escapes the dtype it wraps — widen to the full range but stay *known*
    (deliberate wraparound, e.g. Morton magic multiplies, is not a bug)."""
    bounds = int_bounds(dtype)
    if bounds is None:
        return v
    lo, hi = bounds
    if v.lo >= lo and v.hi <= hi:
        return v
    return Ival(lo, hi, v.known)


def dtype_top(dtype) -> Ival:
    """The fallback abstract value for a dtype (unknown provenance)."""
    bounds = int_bounds(dtype)
    if dtype == torch.bool:
        return Ival(0, 1, False)
    if bounds is not None:
        return Ival(bounds[0], bounds[1], False)
    return Ival(-math.inf, math.inf, False)
