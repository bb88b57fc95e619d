"""Deterministic union-find; port of ``repro/core/union_find.py``.

Min-label hooking plus pointer jumping. Hooking is a scatter-min
(``scatter_reduce_(..., "amin", include_self=True)``), which does not
depend on the order of the edges, so labels (the minimum vertex id of each
component) and round counts are the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["compress", "hook_min", "connected_components", "canonicalize"]


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: parent <- parent[parent] until fixpoint."""
    while True:
        p2 = parent[parent.long()]
        if not bool((p2 != parent).any()):
            return p2
        parent = p2


def hook_min(parent: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """One hooking round: for every masked edge (u, v), hook the larger of
    the two current labels under the smaller. Unmasked edges are no-ops:
    they write ``parent[0]`` onto itself."""
    pu, pv = parent[u.long()], parent[v.long()]
    hi = torch.where(mask, torch.maximum(pu, pv), 0).long()
    lo = torch.where(mask, torch.minimum(pu, pv), parent[hi])
    return parent.scatter_reduce(0, hi, lo, "amin", include_self=True)


def connected_components(n: int, u: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Labels in [0, n): each vertex gets the min vertex id of its
    component over the masked edges (u, v)."""
    if mask is None:
        mask = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    parent = torch.arange(n, dtype=torch.int32, device=u.device)
    while True:
        p2 = compress(hook_min(parent, u, v, mask))
        if not bool((p2 != parent).any()):
            return p2
        parent = p2


def canonicalize(labels: torch.Tensor) -> torch.Tensor:
    """Fully compress an arbitrary label-pointer array into root labels."""
    return compress(labels.to(torch.int32))
