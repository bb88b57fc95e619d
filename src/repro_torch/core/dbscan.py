"""DBSCAN; port of ``repro/core/dbscan.py`` (``fdbscan`` and its passes,
and ``dbscan_graph_cc``), over 63-bit or 30-bit Morton codes.

Phase 1 counts ε-neighbours with early exit at ``min_pts``; phase 2 runs
min-label hooking plus pointer jumping to a fixpoint, each round's labels
coming from a fused traversal; a border pass gives non-core points the
smallest root among their core neighbours. Both traversals are the
wavefront kernel's epilogues (with ``use_stack=True`` the count pass
takes the stack backend, in torch ops, as the reference's does: the
Figure 4 ladder's pre-stackless rungs). Hooking is a deterministic
scatter-min, so
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


def count_neighbors(bvh: Bvh, points, queries: torch.Tensor, eps,
                    min_pts: int | None = None, use_stack: bool = False, *,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """ε-neighbour counts per query, the query point included; with
    ``min_pts`` counting stops (and saturates) there. ``points`` is kept
    for the reference's signature; the engine tests against the tree's
    leaf volumes. ``use_stack`` takes the stack backend."""
    del points
    return query_count(bvh, within(queries, eps), stop_at=min_pts,
                       backend="stack" if use_stack else "stackless",
                       order=None if use_stack else order)


_INT32 = torch.iinfo(torch.int32)


def min_core_label_on(bvh: Bvh, query_pts: torch.Tensor, eps, obj_labels,
                      obj_core, queries_mask, sentinel: int, *,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """For each query in ``queries_mask``, the min over core ε-neighbour
    objects j of ``obj_labels[j]`` (tree object index), ``sentinel`` if
    none and outside the mask. The result has ``obj_labels``'s dtype, as
    the reference's does. The kernel carries int32 labels (ROADMAP B1
    (e)): int64 labels or a sentinel outside the int32 range raise
    ``ValueError`` rather than wrap (an int64 tensor's range costs one
    host sync)."""
    sentinel = int(sentinel)
    if not _INT32.min <= sentinel <= _INT32.max:
        raise ValueError(f"sentinel {sentinel} is outside int32; int64 labels "
                         "are not ported yet (ROADMAP B1 (e))")
    if obj_labels.dtype != torch.int32 and obj_labels.numel() and (
            int(obj_labels.min()) < _INT32.min
            or int(obj_labels.max()) > _INT32.max):
        raise ValueError("obj_labels hold values outside int32; int64 labels "
                         "are not ported yet (ROADMAP B1 (e))")
    pred = within(query_pts, eps)
    out = wavefront_min_label(
        bvh, pred.centers.contiguous(), squared_radii(pred),
        obj_labels.to(torch.int32).contiguous(), obj_core.contiguous(),
        queries_mask.contiguous(), sentinel, order=order)
    return out.to(obj_labels.dtype)


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
    ``use_stack`` takes the stack backend for the count pass only, as the
    reference does; ``use_64bit=False`` builds the tree over 30-bit Morton
    codes."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi, use_64bit=use_64bit)

    # All the traversals of this tree read one packed copy of it.
    with shared_pack(bvh):
        counts = count_neighbors(bvh, points, points, eps,
                                 min_pts if early_stop else None,
                                 use_stack=use_stack, order=bvh.leaf_perm)
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
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi, use_64bit=use_64bit)

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
