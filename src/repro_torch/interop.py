"""Carry the JAX package's state into the port's tensors.

This system has no model weights: its state is the particles and the BVH
(or cell grid) over them. These helpers take that state as numpy arrays,
as the JAX package hands it out, so that a test can run the port's
traversal on the very tree the reference built.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.cell_grid import CellGrid

__all__ = ["bvh_from_numpy", "cell_grid_from_numpy", "morton64_to_int64"]


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dtype).to(device)


def bvh_from_numpy(leaf_perm, left_child, right_child, rope, node_lo, node_hi,
                   range_left, range_right, device="cpu") -> Bvh:
    """A port ``Bvh`` from the reference's eight fields as numpy arrays,
    from ``build_bvh`` or ``build_bvh_objects``: ``box_leaves`` says
    whether any leaf box has extent."""
    i32, f32 = torch.int32, torch.float32
    n = np.asarray(leaf_perm).shape[0]
    leaf_lo = np.asarray(node_lo, np.float32)[n - 1:]
    leaf_hi = np.asarray(node_hi, np.float32)[n - 1:]
    box_leaves = not np.array_equal(leaf_lo.view(np.int32),
                                    leaf_hi.view(np.int32))
    return Bvh(leaf_perm=_t(leaf_perm, i32, device),
               left_child=_t(left_child, i32, device),
               right_child=_t(right_child, i32, device),
               rope=_t(rope, i32, device),
               node_lo=_t(node_lo, f32, device),
               node_hi=_t(node_hi, f32, device),
               range_left=_t(range_left, i32, device),
               range_right=_t(range_right, i32, device),
               box_leaves=box_leaves)


def cell_grid_from_numpy(cell_size, origin, dims, perm, inv_perm,
                         cell_id_sorted, cell_coord_sorted, run_start,
                         run_length, device="cpu") -> CellGrid:
    """A port ``CellGrid`` from the reference's nine fields as numpy
    arrays; the linear cell ids become int64 (the port's dtype)."""
    i32, f32 = torch.int32, torch.float32
    return CellGrid(cell_size=_t(cell_size, f32, device),
                    origin=_t(origin, f32, device),
                    dims=_t(dims, i32, device),
                    perm=_t(perm, i32, device),
                    inv_perm=_t(inv_perm, i32, device),
                    cell_id_sorted=_t(cell_id_sorted, torch.int64, device),
                    cell_coord_sorted=_t(cell_coord_sorted, i32, device),
                    run_start=_t(run_start, i32, device),
                    run_length=_t(run_length, i32, device))


def morton64_to_int64(hi, lo) -> torch.Tensor:
    """The reference's (hi, lo) uint32 code pair as the port's int64."""
    hi = np.asarray(hi, np.uint32).astype(np.int64)
    lo = np.asarray(lo, np.uint32).astype(np.int64)
    return torch.from_numpy((hi << 32) | lo)
