"""Spatial queries; port of ``repro/core/query.py`` (main-path subset:
``Within``, ``within`` and ``query_count``).

Every ε-query runs the rope traversal of
``repro_torch.kernels.wavefront``: the CUDA kernel on the card, its plain
lockstep version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bvh import Bvh
from repro_torch.kernels.wavefront import wavefront_count

__all__ = ["Within", "within", "squared_radii", "query_count"]


class Within(NamedTuple):
    """ε-sphere predicates: all objects within ``radii`` of ``centers``."""
    centers: torch.Tensor  # (q, 3) float32
    radii: torch.Tensor    # (q,) float32


def within(centers: torch.Tensor, radii) -> Within:
    """Sphere predicate; ``radii`` is a scalar eps or a (q,) vector."""
    r = torch.as_tensor(radii, dtype=centers.dtype, device=centers.device)
    return Within(centers=centers, radii=r.expand(centers.shape[0]).contiguous())


def squared_radii(pred: Within) -> torch.Tensor:
    """r² per query, squared in float32 as the reference squares it."""
    r = pred.radii.to(torch.float32)
    return r * r


def query_count(bvh: Bvh, predicates: Within, *, stop_at: int | None = None,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-query intersection counts (int32). ``stop_at`` enables early
    termination: counting stops, and saturates, at ``stop_at``. ``order``
    is the order in which the kernel takes queries (``bvh.leaf_perm`` for
    a self-join); it changes no result."""
    if not isinstance(predicates, Within):
        raise TypeError("the port's query_count takes Within predicates")
    return wavefront_count(bvh, predicates.centers.contiguous(),
                           squared_radii(predicates), stop_at=stop_at,
                           order=order)
