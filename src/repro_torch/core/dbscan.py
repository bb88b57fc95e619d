"""DBSCAN; port of ``repro/core/dbscan.py`` (``fdbscan`` and its passes,
and ``dbscan_graph_cc``).

Phase 1 counts ε-neighbours with early exit at ``min_pts``; phase 2 runs
min-label hooking plus pointer jumping to a fixpoint, each round's labels
coming from a fused traversal; a border pass gives non-core points the
smallest root among their core neighbours. Both traversals are the
wavefront kernel's epilogues. Hooking is a deterministic scatter-min, so
labels (the smallest original index per cluster) and the number of rounds
are the reference's exactly.

``dbscan_graph_cc`` is the paper's pre-callback baseline: it stores the
ε-graph in fixed per-point buffers (``query_fixed``), then runs connected
components over the core-core edges. It needs O(n·capacity) memory, and
its result is right only where no neighborhood exceeds the capacity; the
port keeps both drawbacks, as the reference documents them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import union_find
from repro_torch.core.bvh import Bvh, build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import query_count, query_fixed, squared_radii, within
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.wavefront import shared_pack, wavefront_min_label

NOISE = -1

__all__ = ["NOISE", "DbscanResult", "count_neighbors", "min_core_label_on",
           "union_rounds", "fdbscan", "dbscan_graph_cc"]


class DbscanResult(NamedTuple):
    labels: torch.Tensor      # (n,) int32; cluster root or -1 (noise)
    core_mask: torch.Tensor   # (n,) bool
    num_rounds: torch.Tensor  # () int32, union fixpoint rounds taken


def count_neighbors(bvh: Bvh, queries: torch.Tensor, eps,
                    min_pts: int | None = None, *,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """ε-neighbour counts per query, the query point included; with
    ``min_pts`` counting stops (and saturates) there."""
    return query_count(bvh, within(queries, eps), stop_at=min_pts, order=order)


def min_core_label_on(bvh: Bvh, query_pts: torch.Tensor, eps, obj_labels,
                      obj_core, queries_mask, sentinel: int, *,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """For each query in ``queries_mask``, the min over core ε-neighbour
    objects j of ``obj_labels[j]`` (tree object index), ``sentinel`` if
    none and outside the mask."""
    pred = within(query_pts, eps)
    return wavefront_min_label(
        bvh, pred.centers.contiguous(), squared_radii(pred),
        obj_labels.to(torch.int32).contiguous(), obj_core.contiguous(),
        queries_mask.contiguous(), sentinel, order=order)


def _finish_labels(parent, border_candidate, core, n):
    noise = torch.full_like(parent, NOISE)
    labels = torch.where(core, parent,
                         torch.where(border_candidate < n, border_candidate, noise))
    # Border candidates were captured against possibly stale parents; chase.
    ids = torch.arange(n, dtype=torch.int32, device=parent.device)
    labels_safe = torch.where(labels >= 0, labels, ids)
    resolved = union_find.compress(torch.where(core, parent, labels_safe))
    return torch.where(labels >= 0, resolved, noise)


def union_rounds(bvh: Bvh, points: torch.Tensor, eps, core: torch.Tensor,
                 n: int, max_rounds: int = 64):
    """Fixpoint: hook each core point's root under the min core-neighbour
    label, then pointer-jump. Returns ``(parent, rounds)``."""
    dev = points.device
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    last = torch.full_like(parent, n - 1)
    rounds = 0
    while rounds < max_rounds:
        m = min_core_label_on(bvh, points, eps, parent, core, core, n,
                              order=bvh.leaf_perm)
        # hook: parent[parent[i]] <- min(., m_i) for core i (scatter-min)
        tgt = torch.where(core, parent, last)
        upd = torch.where(core, torch.minimum(m, parent), parent[tgt.long()])
        parent2 = parent.scatter_reduce(0, tgt.long(), upd, "amin",
                                        include_self=True)
        parent2 = union_find.compress(parent2)
        rounds += 1
        changed = bool((parent2 != parent).any())
        parent = parent2
        if not changed:
            break
    return parent, rounds


def fdbscan(points, eps, min_pts: int, *, early_stop: bool = True,
            use_stack: bool = False, use_64bit: bool = True,
            device=None) -> DbscanResult:
    """FDBSCAN over (n, 3) points: fused traversal + count + union.

    Runs on ``device`` (``None``: the CUDA card; raises without one).
    ``use_stack`` and 32-bit Morton codes are not ported yet."""
    if use_stack or not use_64bit:
        raise NotImplementedError(
            "use_stack=True and use_64bit=False are not ported yet "
            "(ROADMAP A8)")
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi)

    # All the traversals of this tree read one packed copy of it.
    with shared_pack(bvh):
        counts = count_neighbors(bvh, points, eps,
                                 min_pts if early_stop else None,
                                 order=bvh.leaf_perm)
        core = counts >= min_pts
        parent, rounds = union_rounds(bvh, points, eps, core, n)
        border = min_core_label_on(bvh, points, eps, parent, core, ~core, n,
                                   order=bvh.leaf_perm)
    labels = _finish_labels(parent, border, core, n)
    return DbscanResult(labels=labels, core_mask=core,
                        num_rounds=torch.tensor(rounds, dtype=torch.int32,
                                                 device=dev))


def dbscan_graph_cc(points, eps, min_pts: int, neighbor_capacity: int = 64,
                    use_64bit: bool = True, *, device=None) -> DbscanResult:
    """The pre-callback baseline: store the ε-graph, then run connected
    components. Surplus neighbours overwrite the last slot of a point's
    buffer, so the result is right only where no neighborhood exceeds
    ``neighbor_capacity``. Runs on ``device`` (``None``: the CUDA card).

    The edges handed to ``connected_components`` are the valid core-core
    slots only; the reference passes all ``n·capacity`` slots with a mask,
    and masked edges are no-ops, so the labels are the same."""
    if not use_64bit:
        raise NotImplementedError(
            "use_64bit=False is not ported yet (ROADMAP A8)")
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi)

    nbrs, counts, _overflow = query_fixed(bvh, within(points, eps),
                                          neighbor_capacity,
                                          order=bvh.leaf_perm)
    core = counts >= min_pts
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    # Core-core edges from the stored graph. The buffer is this function's
    # own, so its -1 padding is clamped to 0 in place (the reference's
    # clip) rather than beside a copy: the buffer is the O(n·capacity)
    # term that bounds n.
    nbr_core = nbrs >= 0
    flat = nbrs.clamp_(min=0).view(-1)
    nbr_core &= core.index_select(0, flat).view(nbrs.shape)
    src, slot = (nbr_core & core[:, None]).nonzero(as_tuple=True)
    parent = union_find.connected_components(n, src, nbrs[src, slot])
    del src, slot
    parent = torch.where(core, parent, ids)

    # Border: min core-neighbour root from the stored graph.
    cand = parent.index_select(0, flat).view(nbrs.shape)
    border = cand.masked_fill_(~nbr_core, n).amin(dim=1)
    labels = _finish_labels(parent, border, core, n)
    return DbscanResult(labels=labels, core_mask=core,
                        num_rounds=torch.tensor(1, dtype=torch.int32,
                                                device=dev))
