"""Euclidean minimum spanning tree; port of ``repro/core/emst.py``: the
reference's Borůvka rounds over one BVH. Each round every point finds its
nearest point in another component (the EMST epilogue of the nearest
kernel in ``kernels/nearest.py`` on the card: best-so-far pruning, and a
subtree skipped where its component interval is the query's component
alone), each component keeps its least outgoing edge (a scatter-min of
float32 d², ties to the least point index), a mutual pair is kept once,
the edges are appended, and the components merge by union-find hooks to
a fixpoint. Scatter-mins (``scatter_reduce_``, "amin") do not depend on
the order of their writes, so edges and rounds are the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import union_find
from repro_torch.core.bvh import Bvh, build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import node_reduce
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.nearest import (check_height, nearest_other_component,
                                         nearest_records, sqrt_rn)

__all__ = ["EmstResult", "emst"]

_INT32_MAX = 2**31 - 1


class EmstResult(NamedTuple):
    edges: torch.Tensor         # (n-1, 2) int32 MST edges (original indices)
    weights: torch.Tensor       # (n-1,) float32 Euclidean lengths
    total_weight: torch.Tensor  # () float32
    rounds: torch.Tensor        # () int32


def _node_component_intervals(bvh: Bvh, comp_sorted: torch.Tensor):
    """Per node, the least and largest component over its leaf range
    (``comp_sorted`` in leaf order), by the engine's ``node_reduce``: a
    node with both equal lies wholly in one component."""
    return node_reduce(
        bvh, (comp_sorted, comp_sorted),
        lambda a, b: (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])),
        (_INT32_MAX, -1))


def _nearest_other_component(bvh: Bvh, points: torch.Tensor,
                             comp: torch.Tensor, **kw):
    """``(d2, j)`` per point: the nearest point of another component,
    (inf, -1) where there is none. ``kw`` goes to the wrapper (thread
    order, records, height)."""
    clo, chi = _node_component_intervals(bvh, comp[bvh.leaf_perm.long()])
    return nearest_other_component(bvh, points, comp, comp,
                                   torch.stack([clo, chi], 1), **kw)


def emst(points, *, device=None) -> EmstResult:
    """Euclidean MST over (n, 3) points by BVH-accelerated Borůvka, at
    most 32 rounds, on ``device`` (``None``: the CUDA card; raises without
    one). Host syncs each round read the edge and component counts.

    Where three or more components' least edges tie exactly (duplicate
    points, lattices), the reference's rule can pick a cycle; it then
    appends the cycle's edges and returns no spanning tree (ROADMAP C11).
    The port raises ``ValueError`` there instead; on every other input
    its edges, weights and rounds are the reference's."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    bvh = build_bvh(points, *scene_bounds(points))
    # The tree does not change between rounds: one record pack, one check
    # of its height, and the self-queries in leaf order.
    walk = dict(order=bvh.leaf_perm, records=nearest_records(bvh),
                height=check_height(bvh))

    # Slot n-1 is the write-trash slot of the lanes that keep no edge.
    edges = torch.full((n, 2), -1, dtype=torch.int32, device=dev)
    weights = torch.zeros(n, dtype=torch.float32, device=dev)
    comp = torch.arange(n, dtype=torch.int32, device=dev)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    n_edges, rounds = 0, 0
    while n_edges < n - 1 and rounds < 32:
        d2, j = _nearest_other_component(bvh, points, comp, **walk)
        # Each component's least outgoing d², then its least index among
        # the points that reach it.
        ci = comp.long()
        best_d = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, ci, d2, "amin")
        is_min = (d2 <= best_d[ci]) & (j >= 0)
        winner = torch.full((n,), n, dtype=torch.int32, device=dev).scatter_reduce(
            0, torch.where(is_min, ci, n - 1), torch.where(is_min, ar, n), "amin")
        picked = (ar == winner[ci]) & is_min

        # The same pair {i, j} picked from both sides (mutual): drop the
        # copy whose component is larger.
        a = torch.where(picked, ar, -1)
        b = torch.where(picked, j, -1)
        js = j.clamp(0, n - 1).long()
        mutual = picked & picked[js] & (j[js] == ar) & (comp > comp[js])
        keep = picked & ~mutual
        kept = int(keep.sum())

        # Merge: union every picked edge, iterated to a fixpoint (a lost
        # union would make a component pick its edge again).
        aa, bb = a.clamp(0, n - 1), b.clamp(0, n - 1)
        roots = int((comp == ar).sum())
        while True:
            c2 = union_find.compress(union_find.hook_min(comp, aa, bb, picked))
            changed = bool((c2 != comp).any())
            comp = c2
            if not changed:
                break
        if roots - int((comp == ar).sum()) != kept:
            raise ValueError(
                "emst: this round's least edges close a cycle, so the result "
                "would not be a spanning tree (three or more components whose "
                "least edges tie exactly; ROADMAP C11)")

        offs = torch.cumsum(keep, 0) - 1
        slot = torch.where(keep, n_edges + offs, n - 1)
        edges[slot] = torch.where(keep[:, None], torch.stack([a, b], 1),
                                  edges[slot])
        weights[slot] = torch.where(keep, sqrt_rn(d2), weights[slot])
        n_edges += kept
        rounds += 1
    edges, weights = edges[:n - 1], weights[:n - 1]
    return EmstResult(edges=edges, weights=weights, total_weight=weights.sum(),
                      rounds=torch.tensor(rounds, dtype=torch.int32, device=dev))
