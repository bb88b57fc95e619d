"""Geometric helpers; port of ``repro/core/geometry.py``.

The reference runs on XLA:CPU, which flushes subnormal floats to zero:
subnormal inputs of an arithmetic operation are read as 0 and subnormal
results are written as 0. PyTorch keeps them. So every squared distance
here flushes each of its products (:func:`flush`), which is where a
subnormal can change an ε or box test: a gap of 1e-20 squares to 1e-40,
a miss at ε = 0 in float32, a hit (0) in the reference. Inputs and
differences need no flush in these helpers: a subnormal can move a
difference only where the difference is below 2^-100, whose square
flushes to 0 either way. The slab test of rays (``core/query.py``)
flushes its inputs and differences as well, since its products scale
them by 1/direction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Aabb", "aabb_of_points", "aabb_union", "scene_bounds",
           "point_aabb_dist2", "aabb_aabb_dist2", "safe_inv", "ray_box",
           "flush", "sum_sq", "ieee_minimum", "ieee_maximum"]

_TINY = torch.finfo(torch.float32).tiny


class Aabb(NamedTuple):
    lo: torch.Tensor  # (..., d)
    hi: torch.Tensor  # (..., d)


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to a zero of their sign, as XLA:CPU
    flushes them; NaN and every normal value unchanged."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def ieee_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min with XLA's semantics: NaN propagates and -0 < +0.
    ``torch.minimum`` returns its first operand on the tie of +0 and -0;
    on a tie the bitwise OR of the two is the one with the sign bit."""
    i32 = torch.int32
    tie = (a.view(i32) | b.view(i32)).view(torch.float32)
    return torch.where(a == b, tie, torch.minimum(a, b))


def ieee_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max with XLA's semantics: NaN propagates and +0 > -0."""
    i32 = torch.int32
    tie = (a.view(i32) & b.view(i32)).view(torch.float32)
    return torch.where(a == b, tie, torch.maximum(a, b))


def aabb_of_points(points: torch.Tensor) -> Aabb:
    return Aabb(points.amin(dim=0), points.amax(dim=0))


def scene_bounds(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scene AABB padded so degenerate extents keep Morton normalization
    well-defined. float32 throughout, as the reference computes it."""
    lo, hi = aabb_of_points(points)
    pad = torch.clamp((hi - lo).amax() * 1e-6, min=1e-6)
    return lo - pad, hi + pad


def aabb_union(a: Aabb, b: Aabb) -> Aabb:
    return Aabb(ieee_minimum(a.lo, b.lo), ieee_maximum(a.hi, b.hi))


def sum_sq(d: torch.Tensor) -> torch.Tensor:
    """``(dx*dx + dy*dy) + dz*dz`` of (m, 3) gaps, each product flushed."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return (flush(dx * dx) + flush(dy * dy)) + flush(dz * dz)


def point_aabb_dist2(p: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Squared distance from points (m, 3) to boxes (m, 3); 0 inside.

    The three products and two sums are separate ops summed left to
    right, ``(dx*dx + dy*dy) + dz*dz``, as XLA sums the reference's last
    axis: no fused multiply-add, so the ε test rounds identically on the
    CPU, on the card and in the CUDA kernel. Subnormal products flush to
    0, as XLA:CPU's do."""
    return sum_sq(torch.clamp(torch.maximum(lo - p, p - hi), min=0.0))


def aabb_aabb_dist2(lo_a: torch.Tensor, hi_a: torch.Tensor,
                    lo_b: torch.Tensor, hi_b: torch.Tensor) -> torch.Tensor:
    """Squared distance between boxes (m, 3); 0 where they overlap, the
    reference's formula: the gaps ``max(lo_b - hi_a, lo_a - hi_b, 0)``,
    squared (flushed) and summed as :func:`point_aabb_dist2` sums them.
    ``IntersectsBox`` tests it ``<= 0``; a per-axis overlap test would
    differ where a gap's square flushes to 0."""
    return sum_sq(torch.clamp(torch.maximum(lo_b - hi_a, lo_a - hi_b),
                               min=0.0))


def safe_inv(direction: torch.Tensor) -> torch.Tensor:
    """1/direction with components below 1e-12 in magnitude nudged off the
    axis, the reference's ``_safe_inv`` (``repro/core/query.py:828-831``)
    as XLA:CPU evaluates it: a subnormal component reads as 0 (inverse
    1e12); one in (-1e-12, 0) gives ``-1e-12 + 1e-12 = 0`` and inverse
    +inf. The division is IEEE float32: a float64 division rounded once to
    float32 is correctly rounded, on the CPU and on the card alike, and a
    subnormal inverse flushes to 0."""
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=direction.device)
    d = flush(direction)
    nudged = torch.sign(d) * tiny + tiny
    den = torch.where(d.abs() < tiny, nudged, d)
    return flush((1.0 / den.double()).float())


def ray_box(origin: torch.Tensor, inv: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor):
    """Slab test of rays (m, 3) against boxes (m, 3): ``(t, hit)``, the
    reference's ``_ray_box`` (``repro/core/query.py:834-841``) with
    ``inv = safe_inv(direction)``. ``t = max(tmin, 0)`` is the entry
    parameter; a NaN (0 * inf, where an origin lies on a face and the
    inverse is infinite) propagates through the mins and maxes, as XLA's
    do, and makes a miss. Inputs, differences and products flush as
    XLA:CPU flushes them; ``t`` is +0, never -0, as XLA's max gives it."""
    o, lo, hi = flush(origin), flush(lo), flush(hi)
    t0 = flush(flush(lo - o) * inv)
    t1 = flush(flush(hi - o) * inv)
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tmax = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    t = torch.where((tmin > 0) | tmin.isnan(), tmin, torch.zeros_like(tmin))
    return t, tmax >= t
