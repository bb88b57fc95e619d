"""Morton codes; port of ``repro/core/morton.py`` (30-bit and 63-bit codes,
their sorts and Karras' delta operator on each).

The reference holds a 63-bit code as a ``(hi, lo)`` pair of uint32, and a
30-bit code as one uint32, because JAX runs without x64. PyTorch has no
unsigned 32-bit shifts or comparisons on the CPU, so the port holds both
as int64: ``hi << 32 | lo`` for the 63-bit code, the uint32 value for the
30-bit one. The sign bit stays clear, so signed int64 order is the
reference's order.

Bit layout (as the reference): coordinate bit ``i`` of x, y, z lands at
code bits ``3i + 2``, ``3i + 1`` and ``3i``.
"""
from __future__ import annotations

import torch

__all__ = [
    "normalize_points",
    "morton32",
    "morton64",
    "sort_by_morton32",
    "sort_by_morton64",
    "common_prefix_length32",
    "common_prefix_length64",
]

_BINS = 1 << 21


def normalize_points(points: torch.Tensor, scene_min: torch.Tensor,
                     scene_max: torch.Tensor) -> torch.Tensor:
    """Map points into [0, 1)^d given the scene bounding box."""
    fi = torch.finfo(points.dtype)
    extent = torch.clamp(scene_max - scene_min, min=fi.tiny)
    unit = (points - scene_min) / extent
    # Clamp so that max-corner points stay inside the last bin.
    return torch.clamp(unit, 0.0, 1.0 - fi.eps)


def _expand_bits_21(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of int64 ``v``: bit i -> bit 3i."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _interleave(unit_points: torch.Tensor, bins: int) -> torch.Tensor:
    """Quantize [0, 1)^3 to ``bins`` per axis and interleave, x highest.
    The clamp is in float space, before the integer cast, as the
    reference's ``_quantize``."""
    q = torch.clamp(torch.floor(unit_points * float(bins)), 0.0,
                    float(bins - 1)).to(torch.int64)
    return ((_expand_bits_21(q[:, 0]) << 2) | (_expand_bits_21(q[:, 1]) << 1)
            | _expand_bits_21(q[:, 2]))


def morton32(unit_points: torch.Tensor) -> torch.Tensor:
    """30-bit codes (int64 holding the reference's uint32) for points in
    [0, 1)^3, 10 bits per axis."""
    return _interleave(unit_points, 1 << 10)


def morton64(unit_points: torch.Tensor) -> torch.Tensor:
    """63-bit codes (int64) for points in [0, 1)^3, 21 bits per axis."""
    return _interleave(unit_points, _BINS)


def sort_by_morton32(codes: torch.Tensor) -> torch.Tensor:
    """Stable argsort: equal codes keep index order, as ``jnp.argsort(...,
    stable=True)``."""
    return torch.sort(codes, stable=True).indices


def sort_by_morton64(codes: torch.Tensor) -> torch.Tensor:
    """Stable argsort: equal codes keep index order, as ``jnp.lexsort``."""
    return torch.sort(codes, stable=True).indices


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values, by a binary search of
    shifts and comparisons. A float ``log2`` would round 63-bit values
    and move the result near powers of two."""
    bl = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> s
        big = y != 0
        x = torch.where(big, y, x)
        bl = bl + big.to(x.dtype) * s
    return bl + (x != 0).to(x.dtype)


def common_prefix_length64(codes: torch.Tensor, i: torch.Tensor,
                           j: torch.Tensor) -> torch.Tensor:
    """Karras' delta for sorted int64 codes with index tie-breaking.

    ``clz64(c_i ^ c_j)`` when the codes differ (the reference's
    ``clz(hi ^ hi')`` or ``32 + clz(lo ^ lo')``), else ``64 + clz32(i ^ j)``
    so that runs of equal codes still split into a balanced hierarchy.
    Out-of-range ``j`` gives -1. int64 in, int64 out."""
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    js = j.clamp(0, n - 1)
    x = codes[i] ^ codes[js]
    d = torch.where(x != 0, 64 - _bit_length(x), 96 - _bit_length(i ^ js))
    return torch.where(valid, d, torch.full_like(d, -1))


def common_prefix_length32(codes: torch.Tensor, i: torch.Tensor,
                           j: torch.Tensor) -> torch.Tensor:
    """Karras' delta for sorted 30-bit codes (int64 holding the
    reference's uint32) with index tie-breaking: ``clz32(c_i ^ c_j)`` when
    the codes differ, else ``32 + clz32(i ^ j)``. Out-of-range ``j`` gives
    -1. int64 in, int64 out."""
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    js = j.clamp(0, n - 1)
    x = codes[i] ^ codes[js]
    d = torch.where(x != 0, 32 - _bit_length(x), 64 - _bit_length(i ^ js))
    return torch.where(valid, d, torch.full_like(d, -1))
