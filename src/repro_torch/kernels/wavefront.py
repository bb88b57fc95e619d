"""Rope traversal with a fused epilogue; port of the Pallas TPU kernel
``wavefront_traverse`` (``repro/kernels/wavefront.py:97``).

The reference kernel takes arbitrary Python callbacks through a
``make_fns`` factory. A CUDA kernel cannot, so the port has a closed set
of two epilogues, one wrapper each, both instantiations of one template in
``csrc/wavefront.cu``:

* :func:`wavefront_count` — ε-hit counts with optional early exit at
  ``stop_at`` (``query_count``, ``repro/core/query.py:990-993``);
* :func:`wavefront_min_label` — the minimum ``obj_labels[j]`` over core
  objects ``j`` hit, ``sentinel`` if none, for queries in ``queries_mask``
  (``min_core_label_on``, ``repro/core/dbscan.py:111-113``).

A wrapper launches the kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors; ``<wrapper>.launches`` counts kernel launches.
The plain version is the lockstep wavefront of the reference kernel
(``repro/kernels/wavefront.py:180-215``): every live query advances one
rope hop per iteration, and queries drop out of the working set when they
finish.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bvh import SENTINEL, Bvh
from repro_torch.core.geometry import point_aabb_dist2
from repro_torch.kernels import _build

__all__ = ["wavefront_count", "wavefront_min_label",
           "wavefront_count_plain", "wavefront_min_label_plain",
           "lockstep_traverse", "count_epilogue", "min_label_epilogue"]

_INT32_MAX = 2**31 - 1


def _check_inputs(bvh: Bvh, centers, r2, order):
    q = centers.shape[0]
    if centers.dtype != torch.float32 or centers.shape != (q, 3):
        raise ValueError(f"centers must be (q, 3) float32, got "
                         f"{tuple(centers.shape)} {centers.dtype}")
    if r2.dtype != torch.float32 or r2.shape != (q,):
        raise ValueError("r2 must be (q,) float32")
    if order is not None and (order.dtype != torch.int32 or order.shape != (q,)):
        raise ValueError("order must be a (q,) int32 permutation")
    if bvh.node_lo.device != centers.device:
        raise ValueError("the tree and the queries must be on one device")


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


def _tree_args(bvh: Bvh):
    if bvh.leaf_perm.dtype != torch.int32 or bvh.node_lo.dtype != torch.float32:
        raise ValueError("Bvh index fields must be int32 and boxes float32")
    return [_ptr(bvh.leaf_perm), _ptr(bvh.left_child), _ptr(bvh.rope),
            _ptr(bvh.node_lo), _ptr(bvh.node_hi), bvh.num_leaves]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_P, _I = ctypes.c_void_p, ctypes.c_int
_TREE = [_P, _P, _P, _P, _P, _I]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wavefront")
    lib.wavefront_count.argtypes = _TREE + [_P, _P, _P, _I, _I, _P, _P]
    lib.wavefront_min_label.argtypes = _TREE + [_P, _P, _P, _I, _P, _P, _P,
                                                _I, _P, _P]
    lib.wavefront_count.restype = lib.wavefront_min_label.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def lockstep_traverse(bvh: Bvh, centers, r2, lanes, carry0, epilogue):
    """Lockstep rope walk over the query indices ``lanes``, the algorithm of
    the reference kernel in torch ops. ``epilogue(carry, node, leaf_hit)
    -> (carry, done)`` runs on the live lanes each hop and must leave lanes
    without ``leaf_hit`` unchanged. Returns the final carry per lane, in
    ``lanes`` order, and the number of node visits (hops) it took."""
    n = bvh.num_leaves
    left, rope = bvh.left_child.long(), bvh.rope.long()
    out = carry0.clone()
    pos = torch.arange(lanes.numel(), device=lanes.device)
    node = torch.zeros_like(lanes)
    carry = carry0
    c, rr = centers[lanes], r2[lanes]
    hops = 0
    while pos.numel():
        hops += pos.numel()
        hit = point_aabb_dist2(c, bvh.node_lo[node], bvh.node_hi[node]) <= rr
        is_leaf = node >= n - 1
        carry, done = epilogue(carry, node, is_leaf & hit)
        node = torch.where(hit & ~is_leaf, left[node.clamp(max=n - 2)],
                           rope[node])
        live = (node != SENTINEL) & ~done
        fin = ~live
        out[pos[fin]] = carry[fin]
        pos, node, carry = pos[live], node[live], carry[live]
        c, rr = c[live], rr[live]
    return out, hops


def count_epilogue(stop_at: int | None):
    """COUNT: one more per leaf hit; done once the count reaches stop_at."""
    stop = _INT32_MAX if stop_at is None else int(stop_at)

    def epilogue(count, _node, leaf_hit):
        count = count + leaf_hit.to(count.dtype)
        return count, leaf_hit & (count >= stop)
    return epilogue


def min_label_epilogue(bvh: Bvh, obj_labels, obj_core):
    """MIN_LABEL: min of ``obj_labels`` over core objects hit; never done."""
    n = bvh.num_leaves
    leaf_perm = bvh.leaf_perm.long()

    def epilogue(best, node, leaf_hit):
        obj = leaf_perm[(node - (n - 1)).clamp(0, n - 1)]
        cand = torch.where(leaf_hit & obj_core[obj], obj_labels[obj], best)
        return torch.minimum(best, cand), torch.zeros_like(leaf_hit)
    return epilogue


def wavefront_count_plain(bvh: Bvh, centers, r2, stop_at=None):
    """ε-hit counts per query, saturating at ``stop_at`` when it is set."""
    q = centers.shape[0]
    lanes = torch.arange(q, device=centers.device)
    zeros = torch.zeros(q, dtype=torch.int32, device=centers.device)
    return lockstep_traverse(bvh, centers, r2, lanes, zeros,
                             count_epilogue(stop_at))[0]


def wavefront_min_label_plain(bvh: Bvh, centers, r2, obj_labels, obj_core,
                              queries_mask, sentinel: int):
    """Min ``obj_labels[j]`` over core objects within r of each query in
    ``queries_mask``; ``sentinel`` for the rest and where none is hit."""
    out = torch.full((centers.shape[0],), int(sentinel), dtype=torch.int32,
                     device=centers.device)
    lanes = torch.nonzero(queries_mask).flatten()
    out[lanes] = lockstep_traverse(
        bvh, centers, r2, lanes, out[lanes],
        min_label_epilogue(bvh, obj_labels, obj_core))[0]
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def wavefront_count(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor, *,
                    stop_at: int | None = None,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) int32 ε-hit counts of ``centers`` with per-query squared radii
    ``r2``, saturating at ``stop_at``. ``order`` (int32 permutation) is the
    order in which threads take queries; it changes no result."""
    _check_inputs(bvh, centers, r2, order)
    if not centers.is_cuda:
        return wavefront_count_plain(bvh, centers, r2, stop_at)
    q = centers.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=centers.device)
    if q == 0:
        return out
    lib = _lib()
    code = lib.wavefront_count(
        *_tree_args(bvh), _ptr(order), _ptr(centers), _ptr(r2), q,
        -1 if stop_at is None else int(stop_at), _ptr(out), _stream())
    _build.check(lib, code, "wavefront_count")
    wavefront_count.launches += 1
    return out


def wavefront_min_label(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                        obj_labels: torch.Tensor, obj_core: torch.Tensor,
                        queries_mask: torch.Tensor, sentinel: int, *,
                        order: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) int32: for each query in ``queries_mask``, the min over core
    objects within r of ``obj_labels`` (int32, tree object index);
    ``sentinel`` where none is hit and outside the mask."""
    _check_inputs(bvh, centers, r2, order)
    if obj_labels.dtype != torch.int32 or obj_core.dtype != torch.bool \
            or queries_mask.dtype != torch.bool:
        raise ValueError("obj_labels must be int32, obj_core and "
                         "queries_mask bool")
    if not centers.is_cuda:
        return wavefront_min_label_plain(bvh, centers, r2, obj_labels,
                                         obj_core, queries_mask, sentinel)
    q = centers.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=centers.device)
    if q == 0:
        return out
    lib = _lib()
    code = lib.wavefront_min_label(
        *_tree_args(bvh), _ptr(order), _ptr(centers), _ptr(r2), q,
        _ptr(obj_labels), _ptr(obj_core), _ptr(queries_mask), int(sentinel),
        _ptr(out), _stream())
    _build.check(lib, code, "wavefront_min_label")
    wavefront_min_label.launches += 1
    return out


wavefront_count.launches = 0
wavefront_min_label.launches = 0
