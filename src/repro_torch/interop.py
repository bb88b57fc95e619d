"""Carry the JAX package's state into the port's tensors.

The halo-finding state is the particles and the BVH (or cell grid) over
them; the LM stack's is a nested dict of parameters and the optimizer's
moments. These helpers take that state as numpy arrays, as the JAX
package hands it out (``jax.tree.map(np.asarray, tree)``), so that a test
can run the port on the very tree or weights the reference built.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.cell_grid import CellGrid

__all__ = ["bvh_from_numpy", "cell_grid_from_numpy", "morton64_to_int64",
           "params_from_numpy", "params_to_numpy", "train_state_from_numpy"]


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


def _tensor_from_numpy(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, dtype=None, device="cpu"):
    """A nested dict of numpy arrays (the reference's parameters or any
    tree of them, ``ml_dtypes`` bfloat16 included) as the port's tree of
    tensors on ``device``; ``dtype`` casts every leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree, dtype, device)


def params_to_numpy(tree):
    """The port's tree of tensors as numpy arrays (bfloat16 leaves as
    float32, which holds them exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def train_state_from_numpy(params, m, v, step, error=None, dtype=None,
                           moment_dtype=None, device="cpu"):
    """A port ``TrainState`` from the reference's ``TrainState`` fields as
    numpy trees: parameters, the moments ``m`` and ``v``, the step and the
    compression error buffers (or None)."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    opt = OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                     device=device),
                   m=params_from_numpy(m, moment_dtype, device),
                   v=params_from_numpy(v, moment_dtype, device),
                   error=None if error is None else
                   params_from_numpy(error, torch.float32, device))
    return TrainState(params_from_numpy(params, dtype, device), opt)
