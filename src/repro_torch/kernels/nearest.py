"""Ordered-stack nearest walks of the LBVH: k nearest neighbours, the
nearest point of another component (EMST) and the nearest ray hit.

No Pallas TPU kernel runs these walks. In the reference they are
``traverse_nearest_stack`` (``repro/core/query.py:429-484``), through
``_nearest_batched`` (``:767-791``) and EMST's
``_nearest_other_component`` (``repro/core/emst.py:57-78``), and
``_ray_batched`` (``repro/core/query.py:844-886``): vmapped
``while_loop``s that XLA fuses into one loop on the device. In torch the
same lockstep walk is a launch per op per hop and a host sync per hop to
end the loop (the generic engine took 10.06 s for 64 rays on a tree of
2^24 boxes on an H100 80GB HBM3, ``chip_smoke.py`` phase 11), so the
three walks are one hand-written CUDA kernel,
``nearest_kernel<EPI>`` in ``csrc/nearest.cu``, with an epilogue each:

* :func:`nearest_knn` — KNN: the k nearest objects of each query by the
  squared distance to their leaf boxes, in a k-slot buffer kept unsorted
  (the worst slot, the first holding the maximum, is replaced when a leaf
  is closer), sorted stably at the end; indices and Euclidean distances;
* :func:`nearest_other_component` — EMST: per query the nearest object
  whose component differs from the query's, with subtrees lying wholly in
  the query's component skipped by their component interval; (d², index);
* :func:`nearest_ray` — RAY: the leaf box each ray enters first (slab
  test, entry ``t``), pruning subtrees whose entry is not closer; (index,
  t).

The walk (``traverse_nearest_stack``): pop a node from a stack of 96; at
a leaf run the epilogue's leaf update with the leaf box's d²; at an
internal node compute both children's d², take ``near = left if dl <=
dr``, and push the far child, then the near one, each where the
epilogue's gate passes on the carry as it stands at that node. A popped
node is never tested again against the tightened bound (the reference's
does not). The ray walk tests the popped node's box, takes a closer leaf,
and pushes the right child, then the left, where each is hit closer than
the best ``t`` (the reference's order).

A wrapper launches the kernel for CUDA tensors and runs the plain version,
the same walk in lockstep torch ops (:func:`ordered_stack_walk`,
:func:`ray_walk`), for CPU tensors; ``<wrapper>.launches`` counts kernel
launches. Every wrapper raises where the tree is 96 levels deep or deeper
(:func:`check_height`), since the stack holds at most height + 1 nodes.
With ``with_pops=True`` each returns the nodes popped per query as well
(the kernel's counter; the plain version's count is the same).

The kernel reads the tree as node records (:func:`nearest_records`, 32
bytes a node): ``{lo.xyz, bits(a)} {hi.xyz, bits(b)}``, with ``(a, b)``
the children of an internal node and ``leaf_perm[k]`` twice at leaf k.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bvh import Bvh, node_depths
from repro_torch.core.geometry import point_aabb_dist2, ray_box
from repro_torch.kernels import _build

__all__ = ["STACK_DEPTH", "LOCAL_K", "nearest_records", "check_height",
           "sqrt_rn", "ordered_stack_walk", "ray_walk", "knn_finish",
           "nearest_knn", "nearest_other_component", "nearest_ray",
           "nearest_knn_plain", "nearest_other_component_plain",
           "nearest_ray_plain"]

# The stack's nodes per query (kStack in csrc/nearest.cu): 64 code bits
# and 32 index tie-break bits bound a tree's height.
STACK_DEPTH = 96
# Up to this k the kernel keeps KNN's buffer in local memory (kLocalK);
# past it, in the output rows themselves.
LOCAL_K = 32

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("nearest")
    lib.nearest_knn.argtypes = [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P]
    lib.nearest_emst.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P]
    lib.nearest_ray.argtypes = [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P]
    for fn in (lib.nearest_knn, lib.nearest_emst, lib.nearest_ray):
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def nearest_records(bvh: Bvh) -> torch.Tensor:
    """(2n-1, 8) float32 node records, int32 bits in columns 3 and 7:
    an internal node's lo, left child, hi, right child; leaf k's lo,
    ``leaf_perm[k]``, hi, ``leaf_perm[k]``. Torch ops, on the tree's
    device; extra memory (2n-1)·32 bytes."""
    if bvh.leaf_perm.dtype != torch.int32 or bvh.node_lo.dtype != torch.float32:
        raise ValueError("Bvh index fields must be int32 and boxes float32")
    a = torch.cat([bvh.left_child, bvh.leaf_perm]).view(torch.float32)
    b = torch.cat([bvh.right_child, bvh.leaf_perm]).view(torch.float32)
    return torch.cat([bvh.node_lo, a[:, None], bvh.node_hi, b[:, None]],
                     1).contiguous()


def check_height(bvh: Bvh, height: int | None = None) -> int:
    """The tree's height (the deepest node's depth, ``node_depths``),
    computed where ``height`` is None; raises unless it is below
    :data:`STACK_DEPTH`, so that no walk can overflow its stack."""
    if height is None:
        height = int(node_depths(bvh).max())
    if height >= STACK_DEPTH:
        raise ValueError(f"the tree is {height} levels deep; the nearest "
                         f"walks' stack holds {STACK_DEPTH} nodes")
    return height


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded: taken in float64 and
    rounded once, as the kernel does. Torch's float32 ``sqrt`` on the CPU
    is not always correctly rounded."""
    return x.double().sqrt().float()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _rows(carry: tuple, idx) -> tuple:
    return tuple(c[idx] for c in carry)


def _set_rows(carry: tuple, idx, new) -> None:
    for c, v in zip(carry, new):
        c[idx] = v


def ordered_stack_walk(bvh: Bvh, centers: torch.Tensor, carry: tuple,
                       push_fn, leaf_fn):
    """``traverse_nearest_stack`` in lockstep torch ops over every query:
    each query pops a node from its row of a ``(q, 96)`` stack; at a leaf,
    ``leaf_fn(lanes, carry, obj, d2) -> carry`` with the leaf box's d²; at
    an internal node the children's d² from ``point_aabb_dist2``, ``near =
    left if dl <= dr``, the far child pushed, then the near one, each where
    ``push_fn(lanes, carry, child, d2) -> (m,) bool``. ``carry`` is a tuple
    of (q, ...) tensors; the callbacks get the rows of the m lanes at such
    a node and their (m,) query indices ``lanes``. Returns the final carry
    and the nodes each query popped (int32)."""
    n, q, dev = bvh.num_leaves, centers.shape[0], centers.device
    left, right = bvh.left_child.long(), bvh.right_child.long()
    out = tuple(c.clone() for c in carry)
    pops = torch.zeros(q, dtype=torch.int32, device=dev)
    stack = torch.zeros((q, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(q, dtype=torch.int64, device=dev)
    pos = torch.arange(q, device=dev)
    cur, c = _rows(out, pos), centers
    while pos.numel():
        pops[pos] += 1
        sp = sp - 1
        node = stack[pos, sp]
        is_leaf = node >= n - 1
        lf = torch.nonzero(is_leaf).flatten()
        if lf.numel():
            nd = node[lf]
            d2 = point_aabb_dist2(c[lf], bvh.node_lo[nd], bvh.node_hi[nd])
            _set_rows(cur, lf, leaf_fn(pos[lf], _rows(cur, lf),
                                       bvh.leaf_perm[nd - (n - 1)], d2))
        inner = torch.nonzero(~is_leaf).flatten()
        if inner.numel():
            nd, ci = node[inner], c[inner]
            lc, rc = left[nd], right[nd]
            dl = point_aabb_dist2(ci, bvh.node_lo[lc], bvh.node_hi[lc])
            dr = point_aabb_dist2(ci, bvh.node_lo[rc], bvh.node_hi[rc])
            near_left = dl <= dr
            near = torch.where(near_left, lc, rc)
            far = torch.where(near_left, rc, lc)
            rows = _rows(cur, inner)
            for child, dc in ((far, torch.maximum(dl, dr)),
                              (near, torch.minimum(dl, dr))):
                g = push_fn(pos[inner], rows, child.to(torch.int32), dc)
                w = inner[g]
                stack[pos[w], sp[w]] = child[g]
                sp[w] += 1
        live = sp > 0
        fin = torch.nonzero(~live).flatten()
        _set_rows(out, pos[fin], _rows(cur, fin))
        keep = torch.nonzero(live).flatten()
        pos, sp, c, cur = pos[keep], sp[keep], c[keep], _rows(cur, keep)
    return out, pops


def ray_walk(bvh: Bvh, origins: torch.Tensor, inv: torch.Tensor):
    """``_ray_batched`` in lockstep torch ops: pop a node, slab-test its
    box (``ray_box``, ``inv`` the rays' ``safe_inv`` directions); where it
    is hit at a ``t`` below the ray's best, a leaf becomes the best and an
    internal node pushes its right child, then its left, each where it is
    hit below the best. Returns ``(index (q,) int32, -1 on a miss; t (q,)
    float32, inf on a miss; pops (q,) int32)``."""
    n, q, dev = bvh.num_leaves, origins.shape[0], origins.device
    left, right = bvh.left_child.long(), bvh.right_child.long()
    best_i = torch.full((q,), -1, dtype=torch.int32, device=dev)
    best_t = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    pops = torch.zeros(q, dtype=torch.int32, device=dev)
    stack = torch.zeros((q, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(q, dtype=torch.int64, device=dev)
    pos = torch.arange(q, device=dev)
    o, iv = origins, inv
    while pos.numel():
        pops[pos] += 1
        sp = sp - 1
        node = stack[pos, sp]
        t_in, hit = ray_box(o, iv, bvh.node_lo[node], bvh.node_hi[node])
        closer = hit & (t_in < best_t[pos])
        is_leaf = node >= n - 1
        take = torch.nonzero(is_leaf & closer).flatten()
        best_i[pos[take]] = bvh.leaf_perm[node[take] - (n - 1)]
        best_t[pos[take]] = t_in[take]
        inner = torch.nonzero(~is_leaf & closer).flatten()
        if inner.numel():
            bt = best_t[pos[inner]]
            for child in (right[node[inner]], left[node[inner]]):
                tc, hc = ray_box(o[inner], iv[inner], bvh.node_lo[child],
                                 bvh.node_hi[child])
                g = hc & (tc < bt)
                w = inner[g]
                stack[pos[w], sp[w]] = child[g]
                sp[w] += 1
        keep = torch.nonzero(sp > 0).flatten()
        pos, sp, o, iv = pos[keep], sp[keep], o[keep], iv[keep]
    return best_i, best_t, pops


def knn_finish(d2: torch.Tensor, idx: torch.Tensor):
    """KNN's buffer (q, k) sorted by d², stably in slot order (as
    ``jnp.argsort``): ``(indices, distances)`` with the distances'
    correctly rounded square roots."""
    order = torch.sort(d2, dim=1, stable=True).indices
    return idx.gather(1, order), sqrt_rn(d2.gather(1, order))


def nearest_knn_plain(bvh: Bvh, centers: torch.Tensor, k: int,
                      with_pops: bool = False):
    """``(indices (q, k) int32, distances (q, k) float32)``, the k nearest
    objects of each query by :func:`ordered_stack_walk` with KNN's gates:
    push where d² is below the buffer's maximum; at a leaf, replace the
    first slot holding the maximum where d² is below it. Unfilled slots
    hold (-1, inf). ``with_pops``: the nodes popped per query too."""
    q, dev = centers.shape[0], centers.device
    d0 = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    i0 = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    if k == 0:
        pops = torch.zeros(q, dtype=torch.int32, device=dev)
        return (i0, d0, pops) if with_pops else (i0, d0)

    def push(_lanes, carry, _child, d2):
        return d2 < carry[0].amax(1)

    def leaf(_lanes, carry, obj, d2):
        dists, idxs = carry
        worst = dists.argmax(1)
        rows = torch.nonzero(d2 < dists.gather(1, worst[:, None])[:, 0]).flatten()
        dists[rows, worst[rows]] = d2[rows]
        idxs[rows, worst[rows]] = obj[rows]
        return dists, idxs

    (d2, idx), pops = ordered_stack_walk(bvh, centers, (d0, i0), push, leaf)
    res = knn_finish(d2, idx)
    return (*res, pops) if with_pops else res


def nearest_other_component_plain(bvh: Bvh, centers: torch.Tensor,
                                  qcomp: torch.Tensor, comp: torch.Tensor,
                                  intervals: torch.Tensor,
                                  with_pops: bool = False):
    """``(d2 (q,) float32, index (q,) int32)`` of the nearest object
    ``j`` with ``comp[j] != qcomp[i]`` for each query ``i``, (inf, -1)
    where there is none, by :func:`ordered_stack_walk` with EMST's gates:
    push where d² is below the best and the child's component interval
    ``intervals[child]`` is not ``[qcomp, qcomp]``; at a leaf, take it
    where its component differs and d² is below the best."""
    q, dev = centers.shape[0], centers.device
    clo, chi = intervals[:, 0], intervals[:, 1]
    carry = (torch.full((q,), float("inf"), dtype=torch.float32, device=dev),
             torch.full((q,), -1, dtype=torch.int32, device=dev))

    def push(lanes, carry, child, d2):
        c = child.long()
        same = (clo[c] == chi[c]) & (clo[c] == qcomp[lanes])
        return (d2 < carry[0]) & ~same

    def leaf(lanes, carry, obj, d2):
        best_d, best_i = carry
        hit = (comp[obj.long()] != qcomp[lanes]) & (d2 < best_d)
        return torch.where(hit, d2, best_d), torch.where(hit, obj, best_i)

    (d2, idx), pops = ordered_stack_walk(bvh, centers, carry, push, leaf)
    return (d2, idx, pops) if with_pops else (d2, idx)


def nearest_ray_plain(bvh: Bvh, origins: torch.Tensor, inv: torch.Tensor,
                      with_pops: bool = False):
    """``(index (q,) int32, t (q,) float32)`` of each ray's nearest leaf
    hit by :func:`ray_walk`; (-1, inf) on a miss."""
    idx, t, pops = ray_walk(bvh, origins, inv)
    return (idx, t, pops) if with_pops else (idx, t)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(bvh: Bvh, qa: torch.Tensor, order, records, what: str):
    q = qa.shape[0]
    if qa.dtype != torch.float32 or qa.shape != (q, 3):
        raise ValueError(f"{what}: queries must be (q, 3) float32, got "
                         f"{tuple(qa.shape)} {qa.dtype}")
    if bvh.node_lo.device != qa.device:
        raise ValueError(f"{what}: the tree and the queries must be on one "
                         "device")
    if order is not None and (order.dtype != torch.int32 or order.shape != (q,)
                              or order.device != qa.device):
        raise ValueError(f"{what}: order must be a (q,) int32 permutation on "
                         "the queries' device")
    if records is not None and (records.dtype != torch.float32
                                or records.shape != (2 * bvh.num_leaves - 1, 8)):
        raise ValueError(f"{what}: records must be nearest_records(bvh)")


def _launch(wrapper, name: str, bvh, records, entry, *args) -> None:
    lib = _lib()
    rec = nearest_records(bvh) if records is None else records
    if rec.data_ptr() % 16:
        raise ValueError("node records must be 16-byte aligned")
    code = getattr(lib, entry)(_ptr(rec), bvh.num_leaves, *args, _stream())
    _build.check(lib, code, name)
    _build.count_launch(wrapper)


def nearest_knn(bvh: Bvh, centers: torch.Tensor, k: int, *,
                order: torch.Tensor | None = None,
                records: torch.Tensor | None = None,
                height: int | None = None, with_pops: bool = False):
    """``(indices (q, k) int32, distances (q, k) float32)``: the k
    nearest objects of each query, by the squared distance to their leaf
    boxes, sorted by it (equal d² in buffer-slot order), with Euclidean
    distances; (-1, inf) in unfilled slots. Any k works: up to
    :data:`LOCAL_K` the kernel's buffer is in local memory, past it in the
    output rows. ``order`` (int32 permutation) is the order in which
    threads take queries; it changes no result. ``records``:
    :func:`nearest_records` of the tree, made here where None; ``height``:
    the tree's height if known (:func:`check_height`). ``with_pops``: the
    nodes popped per query too."""
    _check(bvh, centers, order, records, "nearest_knn")
    k = int(k)
    if k < 0:
        raise ValueError("k must be >= 0")
    check_height(bvh, height)
    if not centers.is_cuda:
        return nearest_knn_plain(bvh, centers, k, with_pops)
    q, dev = centers.shape[0], centers.device
    idx = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    pops = torch.zeros(q, dtype=torch.int32, device=dev) if with_pops else None
    if q and k:
        _launch(nearest_knn, "nearest_knn", bvh, records, "nearest_knn",
                _ptr(order), _ptr(centers), q, k, _ptr(idx), _ptr(dist),
                _ptr(pops))
    return (idx, dist, pops) if with_pops else (idx, dist)


def nearest_other_component(bvh: Bvh, centers: torch.Tensor,
                            qcomp: torch.Tensor, comp: torch.Tensor,
                            intervals: torch.Tensor, *,
                            order: torch.Tensor | None = None,
                            records: torch.Tensor | None = None,
                            height: int | None = None,
                            with_pops: bool = False):
    """``(d2 (q,) float32, index (q,) int32)``: for each query, the
    nearest object whose component (``comp``, (n,) int32 by object)
    differs from the query's (``qcomp``, (q,) int32), (inf, -1) where none
    does. ``intervals`` (2n-1, 2) int32 holds each node's least and
    largest component over its leaves; a subtree whose interval is
    ``[qcomp, qcomp]`` is skipped. ``order``, ``records``, ``height`` and
    ``with_pops`` as :func:`nearest_knn`."""
    _check(bvh, centers, order, records, "nearest_other_component")
    q, n = centers.shape[0], bvh.num_leaves
    for t, shape, what in ((qcomp, (q,), "qcomp"), (comp, (n,), "comp"),
                           (intervals, (2 * n - 1, 2), "intervals")):
        if t.dtype != torch.int32 or t.shape != shape or t.device != centers.device:
            raise ValueError(f"{what} must be {shape} int32 on the queries' "
                             "device")
    check_height(bvh, height)
    if not centers.is_cuda:
        return nearest_other_component_plain(bvh, centers, qcomp, comp,
                                             intervals, with_pops)
    dev = centers.device
    d2 = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((q,), -1, dtype=torch.int32, device=dev)
    pops = torch.zeros(q, dtype=torch.int32, device=dev) if with_pops else None
    if q:
        _launch(nearest_other_component, "nearest_other_component", bvh,
                records, "nearest_emst", _ptr(order), _ptr(centers), q,
                _ptr(qcomp.contiguous()), _ptr(comp.contiguous()),
                _ptr(intervals.contiguous()), _ptr(idx), _ptr(d2), _ptr(pops))
    return (d2, idx, pops) if with_pops else (d2, idx)


def nearest_ray(bvh: Bvh, origins: torch.Tensor, inv: torch.Tensor, *,
                order: torch.Tensor | None = None,
                records: torch.Tensor | None = None,
                height: int | None = None, with_pops: bool = False):
    """``(index (q,) int32, t (q,) float32)``: each ray's nearest leaf-box
    hit, the object index and the entry parameter, (-1, inf) on a miss.
    ``inv`` (q, 3) float32 is ``core.geometry.safe_inv`` of the
    directions. Point and box leaves alike. ``order``, ``records``,
    ``height`` and ``with_pops`` as :func:`nearest_knn`."""
    _check(bvh, origins, order, records, "nearest_ray")
    q = origins.shape[0]
    if inv.dtype != torch.float32 or inv.shape != (q, 3) \
            or inv.device != origins.device:
        raise ValueError("inv must be (q, 3) float32 on the rays' device")
    check_height(bvh, height)
    if not origins.is_cuda:
        return nearest_ray_plain(bvh, origins, inv, with_pops)
    dev = origins.device
    idx = torch.full((q,), -1, dtype=torch.int32, device=dev)
    t = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    pops = torch.zeros(q, dtype=torch.int32, device=dev) if with_pops else None
    if q:
        _launch(nearest_ray, "nearest_ray", bvh, records, "nearest_ray",
                _ptr(order), _ptr(origins), _ptr(inv.contiguous()), q,
                _ptr(idx), _ptr(t), _ptr(pops))
    return (idx, t, pops) if with_pops else (idx, t)


for _wrapper in (nearest_knn, nearest_other_component, nearest_ray):
    _wrapper.launches = 0
del _wrapper
