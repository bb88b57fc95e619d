"""DBSCAN; port of ``repro/core/dbscan.py``: ``fdbscan`` and its passes,
``dbscan_graph_cc``, ``fdbscan_pair`` and ``fdbscan_densebox``, over
63-bit or 30-bit Morton codes.

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

``fdbscan_pair`` runs its union phase on the pair traversal: each core
query captures up to ``edge_capacity`` core neighbours after it in Morton
order whose root differs from its own (the traversal kernel's EDGE
epilogue), then hooks them; rounds repeat while a buffer filled or a label
changed. ``fdbscan_densebox`` builds one tree over the cells of an ε/√d
grid that hold at least ``min_pts`` points (as boxes) and the other
points, and nothing else (the reference's tree also holds a leaf for each
other point of a dense cell, which its callback skips); dense points are
core and pre-unioned, and the two passes are the kernel's DENSE_COUNT and
DENSE_MIN_LABEL epilogues, which take a cell within ε wholesale and scan
it point by point otherwise. Labels, core mask and rounds are the
reference's exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import union_find
from repro_torch.core.bvh import Bvh, build_bvh, build_bvh_objects
from repro_torch.core.cell_grid import CellGrid, build_cell_grid, cell_box
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import query_count, query_fixed, squared_radii, within
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.wavefront import (DENSE_CELL, DENSE_POINT,
                                           dense_leaves, pair_keys, pair_starts,
                                           shared_pack, wavefront_dense_count,
                                           wavefront_dense_min_label,
                                           wavefront_edge, wavefront_min_label)

NOISE = -1

__all__ = ["NOISE", "DbscanResult", "count_neighbors", "min_core_label_on",
           "union_rounds", "fdbscan", "dbscan_graph_cc", "fdbscan_pair",
           "seg_min_per_point", "DenseBoxTree", "densebox_tree",
           "fdbscan_densebox"]


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


def min_core_label_on(bvh: Bvh, query_pts: torch.Tensor, eps, obj_labels,
                      obj_core, queries_mask, sentinel: int, *,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """For each query in ``queries_mask``, the min over core ε-neighbour
    objects j of ``obj_labels[j]`` (tree object index), ``sentinel`` if
    none and outside the mask. The result has ``obj_labels``'s dtype, as
    the reference's does: int32 labels take the kernel's MIN_LABEL
    instance, int64 labels (the sharded path's global ids) its int64 one.
    A sentinel outside the labels' dtype raises ``ValueError``."""
    pred = within(query_pts, eps)
    return wavefront_min_label(
        bvh, pred.centers.contiguous(), squared_radii(pred),
        obj_labels.contiguous(), obj_core.contiguous(),
        queries_mask.contiguous(), int(sentinel), order=order)


def _finish_labels(parent, border_candidate, core, n):
    noise = torch.full_like(parent, NOISE)
    labels = torch.where(core, parent,
                         torch.where(border_candidate < n, border_candidate, noise))
    # Border candidates were captured against possibly stale parents; chase.
    ids = torch.arange(n, dtype=torch.int32, device=parent.device)
    labels_safe = torch.where(labels >= 0, labels, ids)
    resolved = union_find.compress(torch.where(core, parent, labels_safe))
    return torch.where(labels >= 0, resolved, noise)


def _hook(parent: torch.Tensor, m: torch.Tensor, core: torch.Tensor):
    """One union round: parent[parent[i]] <- min(., m_i) for core i (a
    scatter-min; other points write their own root onto itself), then
    pointer jumping."""
    tgt = torch.where(core, parent, parent.shape[0] - 1).long()
    upd = torch.where(core, torch.minimum(m, parent), parent[tgt])
    return union_find.compress(parent.scatter_reduce(0, tgt, upd, "amin",
                                                     include_self=True))


def union_rounds(bvh: Bvh, points: torch.Tensor, eps, core: torch.Tensor,
                 n: int, max_rounds: int = 64):
    """Fixpoint: hook each core point's root under the min core-neighbour
    label, then pointer-jump. Returns ``(parent, rounds)``."""
    dev = points.device
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < max_rounds:
        m = min_core_label_on(bvh, points, eps, parent, core, core, n,
                              order=bvh.leaf_perm)
        parent2 = _hook(parent, m, core)
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


def fdbscan_pair(points, eps, min_pts: int, edge_capacity: int = 8,
                 use_64bit: bool = True, *, device=None) -> DbscanResult:
    """FDBSCAN whose union phase visits each unordered pair once (§4.2.3).

    Each core query i captures up to ``edge_capacity`` cross-root core
    neighbours j after it in Morton order and stops when its buffer fills;
    the captured edges are hooked (``union_find.hook_min``) and the labels
    compressed. Rounds repeat while a buffer filled or a label changed, at
    most 64. Runs on ``device`` (``None``: the CUDA card)."""
    if edge_capacity < 1:
        raise ValueError("edge_capacity must be >= 1")
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi, use_64bit=use_64bit)
    perm = bvh.leaf_perm
    pred = within(points, eps)
    centers = pred.centers[perm.long()].contiguous()
    r2 = squared_radii(pred)[perm.long()].contiguous()
    starts = pair_starts(bvh)
    src = perm.long()[:, None].expand(n, edge_capacity)

    with shared_pack(bvh):
        core = count_neighbors(bvh, points, points, eps, min_pts,
                               order=perm) >= min_pts
        parent = torch.arange(n, dtype=torch.int32, device=dev)
        rounds, go = 0, True
        while go and rounds < 64:
            buf, cnt = wavefront_edge(bvh, centers, r2,
                                      pair_keys(bvh, parent, core),
                                      edge_capacity, start=starts)
            overflow = bool((cnt >= edge_capacity).any())
            # Buffer row k belongs to sorted query k, original leaf_perm[k].
            mask = buf >= 0
            dst = buf[mask]
            parent2 = union_find.compress(union_find.hook_min(
                parent, src[mask], dst, torch.ones_like(dst, dtype=torch.bool)))
            changed = bool((parent2 != parent).any())
            parent, rounds = parent2, rounds + 1
            go = changed or overflow
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        parent = torch.where(core, parent, ids)
        border = min_core_label_on(bvh, points, eps, parent, core, ~core, n,
                                   order=perm)
    labels = _finish_labels(parent, border, core, n)
    return DbscanResult(labels=labels, core_mask=core,
                        num_rounds=torch.tensor(rounds, dtype=torch.int32,
                                                device=dev))


def seg_min_per_point(values_sorted: torch.Tensor, run_start: torch.Tensor,
                      run_length: torch.Tensor) -> torch.Tensor:
    """Per sorted point, the min of ``values_sorted`` over its cell run
    (runs given by ``run_start``, one per head ``run_start[t] == t``), in
    ``values_sorted``'s dtype: a scatter-min over run ids, then a gather.
    ``run_length`` is taken for the reference's signature."""
    del run_length
    n = values_sorted.shape[0]
    idx = torch.arange(n, dtype=run_start.dtype, device=run_start.device)
    run = torch.cumsum((idx == run_start).long(), 0) - 1
    big = torch.iinfo(values_sorted.dtype).max
    mins = torch.full((n,), big, dtype=values_sorted.dtype,
                      device=values_sorted.device)
    mins = mins.scatter_reduce(0, run, values_sorted, "amin")
    return mins[run]


class DenseBoxTree(NamedTuple):
    """DenseBox's tree and what its epilogues read. The points stay in
    grid-sorted order (``grid.perm``), which the runs, the scan and the
    labels index. The tree's m leaves are the tree's objects: each dense
    cell's box (object: its run's head) and each loose point (object:
    itself), and nothing else. The reference's tree has n leaves, also
    one at each other point of a dense cell, which its callback skips,
    because XLA needs static shapes; the kernel walked past those leaves
    and the internal nodes above them and took nothing from them.

    Dropping them changes no result. An internal node's box is the exact
    min/max of its children's, and the rounded point-box test is monotone
    in the box (each gap, its square, its flush and the sum only grow as
    the box grows), so a rope walk reaches every leaf whose box the
    sphere hits, whatever the tree's shape: each query takes the same
    cells and points as on the reference's tree. MIN is order-free, so
    the min labels are equal; without ``stop_at`` the counts are equal;
    with it the core flags are, since the count only grows and is checked
    after whole leaves as before. Where the grid leaves a single object
    (a build needs two), a second leaf copies its box with an empty run,
    which adds nothing (a leaf hit adds its run's length)."""
    grid: CellGrid
    bvh: Bvh
    pts_sorted: torch.Tensor  # (n, 3) float32
    r2: torch.Tensor          # (n,) float32 eps² per sorted query
    dense: torch.Tensor       # (n,) bool: in a cell of >= min_pts points
    obj: torch.Tensor         # (m,) int32 grid-sorted index of each object
    kind: torch.Tensor        # (m,) int32 DENSE_CELL / DENSE_POINT per object
    run_length: torch.Tensor  # (m,) int32 points in each object's run
    order: torch.Tensor       # (n,) int32 query order: the leaves in leaf
                              # order, each cell expanded into its run
    half: float               # half the cell size

    def words(self, label: torch.Tensor) -> torch.Tensor:
        """The (m, 4) leaf words with ``label`` per sorted point, read at
        each object: the cell's least label at a run's head, the point's
        key at a loose point."""
        return dense_leaves(self.bvh, self.obj, self.run_length,
                            label.index_select(0, self.obj), self.kind)


def densebox_tree(points: torch.Tensor, eps, min_pts: int,
                  use_64bit: bool = True) -> DenseBoxTree:
    """The grid of cell ε/√d over ``points`` ((n, 3) float32, on their
    device) and the tree over its dense cells and loose points only
    (``repro/core/dbscan.py:314-333`` builds it over n leaves)."""
    n, d = points.shape
    lo, hi = scene_bounds(points)
    eps_f = torch.tensor(float(eps), dtype=torch.float32)
    cell = float(eps_f / torch.tensor(math.sqrt(d), dtype=torch.float32))
    grid = build_cell_grid(points, lo, hi, cell)
    dense = grid.dense_mask_sorted(min_pts)
    is_cell = dense & grid.is_run_head()
    obj = torch.nonzero(is_cell | ~dense).flatten().to(torch.int32)
    kind = torch.where(is_cell[obj.long()], DENSE_CELL, DENSE_POINT).to(torch.int32)
    run_length = torch.where(kind == DENSE_CELL, grid.run_length[obj.long()], 1)
    if obj.shape[0] == 1:
        obj, kind = obj.repeat(2), kind.repeat(2)
        run_length = torch.cat([run_length, torch.zeros_like(run_length)])
    pts_sorted = points[grid.perm.long()].contiguous()
    cell_lo, cell_hi = cell_box(grid, grid.cell_coord_sorted[obj.long()])
    obj_pts = pts_sorted[obj.long()]
    box = (kind == DENSE_CELL)[:, None]
    bvh = build_bvh_objects(torch.where(box, cell_lo, obj_pts),
                            torch.where(box, cell_hi, obj_pts),
                            lo, hi, use_64bit=use_64bit)
    leaf = bvh.leaf_perm.long()
    lens = run_length[leaf].long()
    first = torch.cumsum(lens, 0) - lens
    owner = torch.repeat_interleave(torch.arange(lens.shape[0], device=lens.device),
                                    lens, output_size=n)
    order = (obj[leaf].long()[owner] + torch.arange(n, device=lens.device)
             - first[owner]).to(torch.int32)
    return DenseBoxTree(grid=grid, bvh=bvh, pts_sorted=pts_sorted,
                        r2=squared_radii(within(pts_sorted, eps)), dense=dense,
                        obj=obj, kind=kind, run_length=run_length.to(torch.int32),
                        order=order, half=float(grid.cell_size * 0.5))


def fdbscan_densebox(points, eps, min_pts: int, use_64bit: bool = True, *,
                     device=None) -> DbscanResult:
    """FDBSCAN-DenseBox (§4.3.4) on :func:`densebox_tree`: dense points
    are core and pre-unioned to their cell's least index; the count pass
    (DENSE_COUNT) runs for the other points, the union rounds
    (DENSE_MIN_LABEL) from every core point and the border pass from the
    rest. Runs on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    n = points.shape[0]
    t = densebox_tree(points, eps, min_pts, use_64bit)
    grid, bvh, pts, dense_s = t.grid, t.bvh, t.pts_sorted, t.dense
    perm = grid.perm.long()
    order = t.order

    with shared_pack(bvh):
        # Phase 1: core points. Dense points are core for free.
        counts_s = wavefront_dense_count(
            bvh, pts, t.r2, t.words(torch.zeros_like(grid.perm)), pts, t.half,
            stop_at=min_pts, qmask=~dense_s, order=order)
        core_s = dense_s | (counts_s >= min_pts)
        core = torch.zeros(n, dtype=torch.bool, device=dev)
        core[perm] = core_s

        def min_label_pass(parent, queries_mask_s):
            scan_lab = parent[perm]
            cell_lab = seg_min_per_point(scan_lab, grid.run_start,
                                         grid.run_length)
            # Read at run heads (cells) and loose points (their key).
            label = torch.where(dense_s, cell_lab,
                                torch.where(core_s, scan_lab, n))
            m_s = wavefront_dense_min_label(
                bvh, pts, t.r2, t.words(label), pts, scan_lab, t.half,
                queries_mask_s, n, order=order)
            out = torch.empty(n, dtype=torch.int32, device=dev)
            out[perm] = m_s
            return out

        # Phase 2: union rounds from every core point, dense cells
        # pre-unioned to their least original index.
        seg_min_orig = seg_min_per_point(grid.perm, grid.run_start,
                                         grid.run_length)
        parent = torch.empty(n, dtype=torch.int32, device=dev)
        parent[perm] = torch.where(dense_s, seg_min_orig, grid.perm)
        parent = union_find.compress(parent)
        rounds = 0
        while rounds < 64:
            parent2 = _hook(parent, min_label_pass(parent, core_s), core)
            rounds += 1
            changed = bool((parent2 != parent).any())
            parent = parent2
            if not changed:
                break

        # Phase 3: the border pass for the other points.
        border = min_label_pass(parent, ~core_s)
    labels = _finish_labels(parent, border, core, n)
    return DbscanResult(labels=labels, core_mask=core,
                        num_rounds=torch.tensor(rounds, dtype=torch.int32,
                                                device=dev))
