"""Ray casting; port of ``repro/core/raycast.py``: the nearest leaf hit of
each ray (``raycast``, the RAY epilogue of the nearest kernel in
``kernels/nearest.py`` on the card) and every leaf each ray pierces
(``raycast_all``, the count-then-fill CSR over the all-hits ``Ray``, the
traversal kernel's RAY instances). Leaves are boxes (``build_bvh_objects``)
or points; rays with t >= 0 only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.query import DeviceCsr, query, query_csr, ray
from repro_torch.device import as_tensor_on

__all__ = ["RayHits", "raycast", "raycast_all"]


class RayHits(NamedTuple):
    index: torch.Tensor  # (r,) int32 original object index (-1 = miss)
    t: torch.Tensor      # (r,) float32 entry parameter along the ray


def _rays(bvh: Bvh, origins, directions):
    dev = bvh.node_lo.device
    return ray(as_tensor_on(origins, torch.float32, dev),
               as_tensor_on(directions, torch.float32, dev))


def raycast(bvh: Bvh, origins, directions) -> RayHits:
    """Nearest hit of each ray; origins and directions (r, 3). The
    kernel's threads take the rays in the Morton order of their origins,
    which changes no result."""
    res = query(bvh, _rays(bvh, origins, directions), sort_queries=True)
    return RayHits(index=res.index, t=res.t)


def raycast_all(bvh: Bvh, origins, directions, *, capacity: int | None = None,
                chunk: int = 32, backend: str = "stackless",
                sort_queries: bool = False) -> DeviceCsr:
    """Every leaf intersection of each ray (in traversal order within a
    row) as CSR: with ``capacity`` device-resident, surplus hits dropped
    and flagged; with ``capacity=None`` one host sync sizes the result
    exactly."""
    return query_csr(bvh, _rays(bvh, origins, directions), capacity=capacity,
                     chunk=chunk, backend=backend, sort_queries=sort_queries)
