"""Geometric helpers; port of ``repro/core/geometry.py`` (main-path subset)."""
from __future__ import annotations

import torch

__all__ = ["scene_bounds", "point_aabb_dist2"]


def scene_bounds(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scene AABB padded so degenerate extents keep Morton normalization
    well-defined. float32 throughout, as the reference computes it."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    pad = torch.clamp((hi - lo).amax() * 1e-6, min=1e-6)
    return lo - pad, hi + pad


def point_aabb_dist2(p: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Squared distance from points (m, 3) to boxes (m, 3); 0 inside.

    The three products and two sums are separate ops summed left to
    right, ``(dx*dx + dy*dy) + dz*dz``, as XLA sums the reference's last
    axis: no fused multiply-add, so the ε test rounds identically on the
    CPU, on the card and in the CUDA kernel."""
    d = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return (dx * dx + dy * dy) + dz * dz
