"""Grid DBSCAN on ε-cells; port of ``repro/core/fdbscan_grid.py``.

Points are binned into a regular grid of ε-sized cells with a fixed
capacity C per cell (padding at ``BIG``); the 3^d stencil of adjacent
cells takes the place of the BVH. Core counts are one ``stencil_count``
launch; clusters come from a host loop of ``stencil_min_label`` launches,
each followed by a scatter-min hook and pointer jumping, until nothing
changes; border points take the min ε-reachable core label. Labels are the
smallest original index per cluster, noise is -1, and the number of rounds
is the reference's.

The distance is the kernel's ‖x‖² + ‖y‖² − 2x·y (``kernels/pairwise.py``),
so near ε the grid can disagree with ``fdbscan``'s Σ(x−y)² (ROADMAP C2).

Slot ids are int32 as in the reference, whose ``lin * capacity + rank``
wraps silently once ``(ncells + 1) * capacity`` passes 2^31 − 1. The port
raises ``ValueError`` there instead, before it allocates anything.
A capacity overflow is reported, not fatal: points past a cell's capacity
go to the sink slot, count 0 neighbours and end as noise, and
``overflowed`` is set; ``fdbscan_grid_auto`` re-bins with doubled capacity.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import union_find
from repro_torch.core.dbscan import NOISE, DbscanResult
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.pairwise import BIG, SENTINEL_LABEL, shared_classes

__all__ = ["CellBins", "GridAutoInfo", "bin_points", "stencil_neighbor_map",
           "fdbscan_grid", "fdbscan_grid_auto", "grid_dims_for"]

_INT32_MAX = 2**31 - 1
# Cells per chunk of ``stencil_neighbor_map``: its int64 temporaries are
# (chunk, 3^d), 57 MB at d = 3.
_MAP_CHUNK = 1 << 18


class CellBins(NamedTuple):
    """Slot-padded cell layout. ncells = prod(grid_dims); slot space is
    (ncells + 1, capacity) with the last cell all padding (stencil sink)."""

    cell_pts: torch.Tensor       # (ncells + 1, C, D) float32, padded with BIG
    slot_of_point: torch.Tensor  # (n,) int32 flat slot id; overflow -> sink slot
    overflowed: torch.Tensor     # () bool: any point dropped by capacity

    @property
    def num_cells(self) -> int:
        return self.cell_pts.shape[0] - 1


class GridAutoInfo(NamedTuple):
    """What ``fdbscan_grid_auto``'s capacity doubling cost."""
    attempts: int     # binnings taken (1 = no retry)
    capacity: int     # cell capacity of the attempt that fit
    overflowed: bool  # whether any attempt overflowed (retries happened)


def grid_dims_for(scene_lo, scene_hi, cell_size: float) -> tuple[int, ...]:
    """Grid dims covering the scene box with cells of ``cell_size``."""
    lo = np.asarray(scene_lo, np.float64)
    hi = np.asarray(scene_hi, np.float64)
    return tuple(int(max(1, math.ceil(e / cell_size))) for e in (hi - lo))


def _check_slot_space(grid_dims, capacity: int) -> None:
    ncells = math.prod(grid_dims)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if (ncells + 1) * capacity > _INT32_MAX:
        raise ValueError(
            f"slot space (ncells + 1) * capacity = ({ncells} + 1) * {capacity}"
            f" passes the int32 limit 2^31 - 1 of the slot ids; use a larger"
            f" cell or fewer cells")


def stencil_neighbor_map(grid_dims: tuple[int, ...], reach: int = 1, *,
                         device=None) -> torch.Tensor:
    """(ncells, (2*reach+1)^d) int32 candidate-cell map on ``device``
    (``None``: the CUDA card); ncells (the sink) for out-of-range
    neighbours. Offsets run in C order, the last axis fastest, as the
    reference's ``meshgrid(indexing="ij")``."""
    dev = resolve_device(device)
    dims = [int(v) for v in grid_dims]
    ncells = math.prod(dims)
    if ncells + 1 > _INT32_MAX:
        raise ValueError(f"{ncells} cells: cell ids pass int32")
    span = range(-reach, reach + 1)
    offs = torch.tensor(list(itertools.product(span, repeat=len(dims))),
                        dtype=torch.int64, device=dev).reshape(-1, len(dims))
    strides = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    out = torch.empty((ncells, offs.shape[0]), dtype=torch.int32, device=dev)
    for start in range(0, ncells, _MAP_CHUNK):
        cell = torch.arange(start, min(ncells, start + _MAP_CHUNK),
                            dtype=torch.int64, device=dev)
        lin = torch.zeros((cell.numel(), offs.shape[0]), dtype=torch.int64,
                          device=dev)
        ok = torch.ones_like(lin, dtype=torch.bool)
        for k, (dim, stride) in enumerate(zip(dims, strides)):
            c = (cell // stride % dim)[:, None] + offs[:, k]
            ok &= (c >= 0) & (c < dim)
            lin = lin * dim + c
        out[start:start + cell.numel()] = torch.where(ok, lin, ncells)
    return out


def bin_points(points: torch.Tensor, scene_lo, cell_size,
               grid_dims: tuple[int, ...], capacity: int) -> CellBins:
    """Bin (n, d) float32 ``points`` into cells of ``cell_size`` from
    ``scene_lo``, ranked within each cell in index order (a stable sort).
    Runs where ``points`` lie."""
    _check_slot_space(grid_dims, capacity)
    n, d = points.shape
    dev = points.device
    ncells = math.prod(grid_dims)
    lo = as_tensor_on(scene_lo, torch.float32, dev)
    size = torch.tensor(float(cell_size), dtype=torch.float32)
    top = torch.tensor([g - 1 for g in grid_dims], dtype=torch.float32,
                       device=dev)
    # Clamped in float before the cast, where the reference clips the int.
    coord = torch.floor((points - lo) / size).clamp(min=0).minimum(top)
    coord = coord.to(torch.int32)
    lin = coord[:, 0]
    for k in range(1, d):
        lin = lin * grid_dims[k] + coord[:, k]

    # Rank within cell: stable sort by cell, rank = position - run start.
    lin_sorted, order = torch.sort(lin, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = lin_sorted[1:] != lin_sorted[:-1]
    run_start = torch.cummax(torch.where(is_head, idx, 0), 0).values
    rank_sorted = idx - run_start

    ok_sorted = rank_sorted < capacity
    sink = ncells * capacity
    slot_sorted = torch.where(ok_sorted, lin_sorted * capacity + rank_sorted,
                              sink)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    slot[order] = slot_sorted

    flat = torch.full(((ncells + 1) * capacity, d), BIG, dtype=torch.float32,
                      device=dev)
    flat[slot.long()] = points.to(torch.float32)
    # Overflow points all land on the sink slot; it must stay padding.
    flat[sink] = BIG
    return CellBins(cell_pts=flat.view(ncells + 1, capacity, d),
                    slot_of_point=slot, overflowed=(~ok_sorted).any())


def _scatter_slots(values: torch.Tensor, fill, bins: CellBins,
                   slot: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Per-point values in the (ncells+1, C) slot layout; ``slot`` is
    ``bins.slot_of_point`` as int64."""
    ncells_p1, cap = bins.cell_pts.shape[:2]
    flat = torch.full((ncells_p1 * cap,), fill, dtype=dtype,
                      device=values.device)
    flat[slot] = values.to(dtype)
    flat[bins.num_cells * cap:] = fill  # overflow writes land in the sink
    return flat.view(ncells_p1, cap)


def _gather_slots(cells: torch.Tensor, slot: torch.Tensor, fill) -> torch.Tensor:
    """Per-point values of an (ncells, C) result; ``fill`` at the sink."""
    flat = cells.view(-1)
    sink = flat.numel()
    return torch.where(slot < sink, flat[slot.clamp(max=max(sink - 1, 0))],
                       fill)


def _cluster(points: torch.Tensor, eps, min_pts: int, bins: CellBins,
             nbr_map: torch.Tensor, max_rounds: int) -> DbscanResult:
    # Every stencil launch reads one slot-class mask of the cells.
    with shared_classes(bins.cell_pts):
        return _cluster_passes(points, eps, min_pts, bins, nbr_map, max_rounds)


def _cluster_passes(points, eps, min_pts, bins, nbr_map, max_rounds):
    n = points.shape[0]
    dev = points.device
    slot = bins.slot_of_point.long()

    # Phase 1: core classification (one counting launch).
    counts_cells = kops.cell_stencil_counts(bins.cell_pts, nbr_map, eps)
    core = _gather_slots(counts_cells, slot, 0) >= min_pts
    del counts_cells
    core_slots = _scatter_slots(core, False, bins, slot, dtype=torch.bool)

    def min_label_pass(parent):
        lab_slots = _scatter_slots(torch.where(core, parent, SENTINEL_LABEL),
                                   SENTINEL_LABEL, bins, slot)
        m_cells = kops.cell_stencil_min_label(bins.cell_pts, lab_slots,
                                              core_slots, nbr_map, eps)
        return _gather_slots(m_cells, slot, SENTINEL_LABEL)

    # Phase 2: union fixpoint (min-label launch, hook, compress).
    parent0 = torch.arange(n, dtype=torch.int32, device=dev)
    parent = parent0
    last = torch.full_like(parent0, n - 1)
    rounds = 0
    while rounds < max_rounds:
        m = min_label_pass(parent)
        m = torch.where(core & (m != SENTINEL_LABEL), m, parent)
        tgt = torch.where(core, parent, last).long()
        upd = torch.where(core, torch.minimum(m, parent), parent[tgt])
        parent2 = parent.scatter_reduce(0, tgt, upd, "amin", include_self=True)
        parent2 = union_find.compress(parent2)
        rounds += 1
        changed = bool((parent2 != parent).any())
        parent = parent2
        if not changed:
            break

    # Border assignment: min core-neighbour root.
    cand = min_label_pass(parent)
    border_ok = ~core & (cand != SENTINEL_LABEL)
    cand_safe = torch.where(cand == SENTINEL_LABEL, 0, cand)
    resolved = union_find.compress(
        torch.where(core, parent, torch.where(border_ok, cand_safe, parent0)))
    labels = torch.where(core | border_ok, resolved, NOISE).to(torch.int32)
    return DbscanResult(labels=labels, core_mask=core,
                        num_rounds=torch.tensor(rounds, dtype=torch.int32,
                                                device=dev))


def fdbscan_grid(points, eps, min_pts: int, *, scene_lo,
                 grid_dims: tuple[int, ...], capacity: int,
                 max_rounds: int = 64,
                 device=None) -> tuple[DbscanResult, torch.Tensor]:
    """Grid DBSCAN over (n, d) points. ``grid_dims`` must tile the scene
    with cells of size >= eps (``grid_dims_for(lo, hi, eps)``). Runs on
    ``device`` (``None``: the CUDA card; raises without one).

    Returns ``(DbscanResult, overflowed)``, ``overflowed`` a () bool tensor."""
    _check_slot_space(grid_dims, capacity)
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    bins = bin_points(points, scene_lo, eps, grid_dims, capacity)
    nbr_map = stencil_neighbor_map(grid_dims, device=dev)
    return _cluster(points, eps, min_pts, bins, nbr_map, max_rounds), \
        bins.overflowed


def fdbscan_grid_auto(points, eps, min_pts: int, *, scene_lo, scene_hi,
                      capacity: int = 64, max_doublings: int = 6,
                      with_info: bool = False, max_rounds: int = 64,
                      device=None):
    """Grid DBSCAN that re-bins with doubled cell capacity while any cell
    overflows. An attempt that overflows stops right after binning: its
    result would be discarded, so the returned result and info are the
    reference's, and it launches no kernel. Raises ``RuntimeError`` after
    ``max_doublings`` doublings, and ``ValueError`` before an attempt whose
    slot space would pass int32.

    With ``with_info=True`` returns ``(DbscanResult, GridAutoInfo)``."""
    dims = grid_dims_for(scene_lo, scene_hi, float(eps))
    _check_slot_space(dims, capacity)
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    cap = capacity
    for attempt in range(1, max_doublings + 2):
        bins = bin_points(points, scene_lo, eps, dims, cap)
        if not bool(bins.overflowed):
            nbr_map = stencil_neighbor_map(dims, device=dev)
            res = _cluster(points, eps, min_pts, bins, nbr_map, max_rounds)
            if with_info:
                return res, GridAutoInfo(attempts=attempt, capacity=cap,
                                         overflowed=attempt > 1)
            return res
        del bins
        cap *= 2
    raise RuntimeError(
        f"fdbscan_grid_auto: capacity {cap // 2} still overflows after "
        f"{max_doublings} doublings (n={points.shape[0]}, dims={dims})")
