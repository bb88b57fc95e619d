"""Legacy traversal entry points; port of ``repro/core/traversal.py``:
thin shims over the generic engine ``repro_torch.core.query.traverse``,
in torch ops on the tree's device.

Shim contract (the reference's): ``leaf_fn`` runs on EVERY reached leaf
(exact filtering is the callback's job) and returns ``(carry, done)``;
``eps`` is a scalar or a (q,) vector of per-query radii. As in the
engine, callbacks take lane batches: the carries of the m lanes at a
leaf, and (m,) int32 indices.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.geometry import point_aabb_dist2
from repro_torch.core.query import traverse

__all__ = [
    "traverse_sphere_stackless",
    "traverse_sphere_stack",
    "pair_traverse_sphere",
]


def _sphere_qdata(centers: torch.Tensor, eps):
    eps_q = torch.as_tensor(eps, dtype=centers.dtype, device=centers.device)
    eps_q = eps_q.expand(centers.shape[0])
    return (centers, eps_q * eps_q)


def _sphere_node_fn(bvh: Bvh, center_at: int = 0):
    def node_fn(q, carry, node):
        return point_aabb_dist2(q[center_at], bvh.node_lo[node],
                                bvh.node_hi[node]) <= q[center_at + 1]
    return node_fn


def traverse_sphere_stackless(bvh: Bvh, centers: torch.Tensor, eps,
                              leaf_fn: Callable, carry_init,
                              start_nodes: torch.Tensor | None = None):
    """Rope-based stackless traversal; ``leaf_fn(carry, obj_idx,
    sorted_idx) -> (carry, done)``."""
    return traverse(bvh, _sphere_qdata(centers, eps), _sphere_node_fn(bvh),
                    lambda q, c, obj, k: leaf_fn(c, obj, k), carry_init,
                    backend="stackless", start_nodes=start_nodes)


def traverse_sphere_stack(bvh: Bvh, centers: torch.Tensor, eps,
                          leaf_fn: Callable, carry_init):
    """Classic stack-based traversal (the Fig. 4 pre-stackless baseline)."""
    return traverse(bvh, _sphere_qdata(centers, eps), _sphere_node_fn(bvh),
                    lambda q, c, obj, k: leaf_fn(c, obj, k), carry_init,
                    backend="stack")


def pair_traverse_sphere(bvh: Bvh, points: torch.Tensor, eps,
                         leaf_fn: Callable, carry_init):
    """Pair traversal (§4.2.3): one query per point, starting at its own
    leaf's rope, so only pairs (k, m) with k < m in Morton order are
    visited. ``leaf_fn(carry, i_orig, j_orig) -> (carry, done)`` gets the
    original indices of both endpoints. Carries come in sorted query order
    (row k belongs to ``bvh.leaf_perm[k]``). This needs no pair backend:
    it is the stackless walk from ``rope[leaf k]``."""
    n = bvh.num_leaves
    perm = bvh.leaf_perm.long()
    starts = bvh.rope[torch.arange(n, device=perm.device) + (n - 1)]
    qdata = (bvh.leaf_perm,) + _sphere_qdata(points[perm], eps)
    return traverse(bvh, qdata, _sphere_node_fn(bvh, 1),
                    lambda q, c, obj, k: leaf_fn(c, q[0], obj), carry_init,
                    backend="stackless", start_nodes=starts)
