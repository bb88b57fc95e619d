"""k-nearest-neighbour search; port of ``repro/core/knn.py``: the
``nearest(k)`` predicate through the query engine, whose ordered-stack
walk with a bounded candidate buffer is the KNN epilogue of the nearest
kernel (``kernels/nearest.py``) on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.query import nearest, query
from repro_torch.device import as_tensor_on

__all__ = ["KnnResult", "knn"]


class KnnResult(NamedTuple):
    indices: torch.Tensor    # (q, k) int32 original point indices, by distance
    distances: torch.Tensor  # (q, k) float32 Euclidean distances


def knn(bvh: Bvh, points, queries, k: int) -> KnnResult:
    """The k nearest points (by Euclidean distance) of each query row, on
    the tree's device. ``points`` is kept for the reference's signature;
    the walk reads the leaf boxes (the points, for a point tree). The
    kernel's threads take the queries in Morton order, which changes no
    result."""
    del points
    n = bvh.num_leaves
    assert k <= n, (k, n)
    queries = as_tensor_on(queries, torch.float32, bvh.node_lo.device)
    res = query(bvh, nearest(queries, k), sort_queries=True)
    return KnnResult(indices=res.indices, distances=res.distances)
