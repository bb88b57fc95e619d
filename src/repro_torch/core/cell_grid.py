"""Regular grid over the points; port of ``repro/core/cell_grid.py``
(paper §4.3.4, Figure 9).

FDBSCAN-DenseBox superimposes a grid of cell length ε/√d, so that every
cell's diameter is at most ε: a cell holding at least ``min_pts`` points
holds only core points. As in the reference the grid is never
materialized: points are sorted by linear cell id (stably), every cell is
then a run of the sorted order, and each sorted point carries its run's
start and length.

Linear cell ids are int64. The reference linearizes in int32
(``repro/core/cell_grid.py:54-61``), which wraps once the grid has more
than 2^31 cells, and DenseBox's cells of ε/√3 at HACC's linking length
reach 1.8e10 cells at 2^24 particles: cells far apart then share a run
(ROADMAP C9). Where the ids would not fit in int64, or a dimension
would need more than ``max_dim_cells`` cells (the reference clamps it and
so merges the cells past the clamp), ``build_cell_grid`` raises instead.
Every other field has the reference's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["CellGrid", "build_cell_grid", "cell_box"]


class CellGrid(NamedTuple):
    """Sorted-run grid structure over n points in d dims."""

    cell_size: torch.Tensor          # () float32
    origin: torch.Tensor             # (d,) grid origin (scene lo)
    dims: torch.Tensor               # (d,) int32 cells per dimension
    perm: torch.Tensor               # (n,) int32 sorted position -> original index
    inv_perm: torch.Tensor           # (n,) int32 original index -> sorted position
    cell_id_sorted: torch.Tensor     # (n,) int64 linear cell id per sorted point
    cell_coord_sorted: torch.Tensor  # (n, d) int32 cell coordinate per sorted point
    run_start: torch.Tensor          # (n,) int32 start of the point's cell run
    run_length: torch.Tensor         # (n,) int32 points in the point's cell

    @property
    def num_points(self) -> int:
        return self.perm.shape[0]

    def dense_mask_sorted(self, min_pts: int) -> torch.Tensor:
        """True for sorted points in a dense cell (run_length >= min_pts)."""
        return self.run_length >= min_pts

    def is_run_head(self) -> torch.Tensor:
        """True for the first sorted point of each cell run."""
        idx = torch.arange(self.num_points, dtype=torch.int32,
                           device=self.perm.device)
        return idx == self.run_start


def _linearize(coord: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Row-major linear cell id, int64."""
    lin = coord[..., 0].long()
    for k in range(1, coord.shape[-1]):
        lin = lin * int(dims[k]) + coord[..., k].long()
    return lin


def build_cell_grid(points: torch.Tensor, scene_lo: torch.Tensor,
                    scene_hi: torch.Tensor, cell_size,
                    max_dim_cells: int = 1 << 30) -> CellGrid:
    """Bin (n, d) float32 points into a regular grid of cell length
    ``cell_size`` (float32), on the points' device. The sort is stable,
    so the structure is deterministic. Raises ValueError where a dimension
    needs more than ``max_dim_cells`` cells or the linear ids would pass
    int64 (ROADMAP C9): cells far apart would then share a run."""
    n, _ = points.shape
    dev, i32 = points.device, torch.int32
    cs = torch.as_tensor(cell_size, dtype=points.dtype, device=dev)
    span = torch.ceil((scene_hi - scene_lo) / cs).clamp(min=1)
    want = span.tolist()
    if not all(x <= max_dim_cells for x in want) \
            or math.prod(int(x) for x in want) > 2**63:
        raise ValueError(f"a grid of {want} cells of {float(cs)} does not fit: "
                         f"at most {max_dim_cells} a dimension and 2^63 in "
                         f"all, or linear cell ids would merge cells (C9)")
    dims = span.long()
    coord = torch.floor((points - scene_lo) / cs).long()
    coord = torch.minimum(coord.clamp(min=0), dims - 1).to(i32)
    dims = dims.to(i32)
    lin = _linearize(coord, dims)

    lin_sorted, order = torch.sort(lin, stable=True)
    perm = order.to(i32)
    idx = torch.arange(n, dtype=i32, device=dev)
    inv_perm = torch.empty_like(perm)
    inv_perm[order] = idx

    # Run structure: heads by neighbour comparison, starts by a max-scan,
    # ends (exclusive) by a reverse min-scan of the next heads.
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = lin_sorted[1:] != lin_sorted[:-1]
    run_start = torch.cummax(torch.where(is_head, idx, 0), 0).values
    next_head = torch.full((n,), n, dtype=i32, device=dev)
    next_head[:-1] = torch.where(is_head[1:], idx[1:], n)
    run_end = torch.cummin(next_head.flip(0), 0).values.flip(0)
    return CellGrid(cell_size=cs, origin=scene_lo, dims=dims, perm=perm,
                    inv_perm=inv_perm, cell_id_sorted=lin_sorted,
                    cell_coord_sorted=coord[order],
                    run_start=run_start, run_length=run_end - run_start)


def cell_box(grid: CellGrid, coord: torch.Tensor):
    """AABB ``(lo, hi)`` of the grid cells at integer coordinates (..., d):
    ``origin + coord * cell_size``, a product and a sum rounded apart (the
    reference's XLA may contract them into one FMA, ROADMAP C8)."""
    lo = grid.origin + coord.to(grid.origin.dtype) * grid.cell_size
    return lo, lo + grid.cell_size
