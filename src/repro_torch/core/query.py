"""The query engine; port of ``repro/core/query.py``: the predicates
``Within``, ``IntersectsBox``, ``Nearest`` and ``Ray``, the output protocols
``query_count`` (``stop_at=``, ``with_stats=``, ``start_nodes=``),
``query_fixed``, ``query_csr_device``, ``query_csr`` and
``query_csr_buffered``, the generic engine ``query``/``traverse``/
``traverse_nearest_stack``/``node_reduce``, and
``query_sort_permutation``/``node_depths``.

Backends (``backend=``), as the reference names them:

* ``"stackless"`` (the default): the rope traversal of
  ``repro_torch.kernels.wavefront``, the CUDA kernel on the card and its
  plain lockstep version on the CPU;
* ``"pallas"``: the same path. The reference's Pallas backend gives the
  results of its ``stackless`` one on every protocol, and callers ported
  from it (``examples/quickstart.py:98``) pass it;
* ``"stack"``: the reference's ``_one_stack``/``_one_stack_stats``
  (``repro/core/query.py:212-245``, ``:312-353``), a lockstep walk in torch
  ops with a ``(lanes, 96)`` int32 stack, pushing right then left, on
  whatever device the tensors lie (the reference's stack backend is no
  Pallas kernel either). It visits leaves in rope order, so every protocol
  gives the stackless results;
* ``"pair"`` (``query`` only): the self-join of ``_pair_query``
  (``repro/core/query.py:733-765``). Query k is the tree's sorted point k,
  starting at ``rope[leaf k]``, so it visits only the leaves after k in
  rope order and each unordered pair once; its ``query_idx`` is
  ``leaf_perm[k]`` and carries (and stats rows) come back in sorted order.
  A generic callback runs in torch ops; ``fdbscan_pair`` and
  ``pair_count_histogram`` run the same walk as the kernel's EDGE and
  HISTOGRAM epilogues.

The protocols never route a CUDA tensor through the generic engine or
through a plain version: on the card, stackless and pallas launch the
kernel, and stack runs its own walk in torch ops. The generic engine
(``query`` with a callback, ``traverse``, ``node_reduce``) takes arbitrary
Python callbacks, which a kernel's closed set of epilogues cannot, so it
runs in torch ops wherever the tensors lie. Its callbacks take lane
batches: ``callback(carry, query_idx, obj_idx, value) -> (carry, done)``
gets the carries of the m lanes that hit a leaf, their (m,) int32 query
and object indices and (m,) float32 values (the squared distance, or for
a ``Ray`` the entry parameter ``t``); ``done`` is a Python bool or an
(m,) bool tensor.

``query`` with ``Nearest`` (``NearestResult``, or carries through the
nearest callback protocol) and with a ``Ray`` and no callback (the
nearest-hit protocol, ``RayResult``) runs the ordered-stack walks of
``repro_torch.kernels.nearest``: the CUDA kernel on the card, its plain
lockstep version on the CPU. The generic ``traverse_nearest_stack`` takes
arbitrary callbacks and runs in torch ops wherever the tensors lie.

Every protocol takes the reference's ``sort_queries=``: the Morton
permutation of the query centres (box centres, ray origins) becomes the
order in which the kernel's threads take queries (``order``), which
changes no result. A caller that already knows a good order, such as
``bvh.leaf_perm`` for a self-join, passes it as ``order`` instead. The
torch-op walks take queries in index order: order changes none of their
results either.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.bvh import SENTINEL, Bvh, node_depths
from repro_torch.core.geometry import safe_inv
from repro_torch.core.morton import morton32, normalize_points, sort_by_morton32
from repro_torch.kernels.nearest import (STACK_DEPTH, nearest_knn,
                                         nearest_ray, ordered_stack_walk)
from repro_torch.kernels.wavefront import (count_epilogue, fill_epilogue,
                                           fill_lanes, fixed_carry,
                                           fixed_epilogue, pair_starts,
                                           pred_test, wavefront_count,
                                           wavefront_fill, wavefront_fixed)
from repro_torch.obs.stats import TraversalStats

__all__ = ["Within", "IntersectsBox", "Nearest", "Ray", "within",
           "intersects_box", "nearest", "ray", "squared_radii",
           "query_geometry", "NearestResult", "RayResult", "DeviceCsr",
           "BufferedCsr", "query", "query_count", "query_fixed", "query_csr",
           "query_csr_device", "query_csr_buffered", "traverse",
           "stack_traverse", "traverse_nearest_stack", "node_reduce",
           "node_depths", "query_sort_permutation"]



# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

class Within(NamedTuple):
    """ε-sphere predicates: all objects within ``radii`` of ``centers``."""
    centers: torch.Tensor  # (q, 3) float32
    radii: torch.Tensor    # (q,) float32


class IntersectsBox(NamedTuple):
    """AABB-overlap predicates: all objects intersecting [lo, hi]."""
    lo: torch.Tensor  # (q, 3) float32
    hi: torch.Tensor  # (q, 3) float32


class Nearest(NamedTuple):
    """k-nearest predicates. ``k`` is a Python int."""
    centers: torch.Tensor  # (q, 3)
    k: int


class Ray(NamedTuple):
    """Ray predicates: without a callback the nearest hit, with one the
    all-hits protocol (slab test against leaf volumes)."""
    origins: torch.Tensor     # (q, 3) float32
    directions: torch.Tensor  # (q, 3) float32


class NearestResult(NamedTuple):
    indices: torch.Tensor    # (q, k) int32, sorted by distance (-1 = unfilled)
    distances: torch.Tensor  # (q, k) float32 Euclidean


class RayResult(NamedTuple):
    index: torch.Tensor  # (q,) int32 original object index (-1 = miss)
    t: torch.Tensor      # (q,) float32 entry parameter along the ray


def within(centers: torch.Tensor, radii) -> Within:
    """Sphere predicate; ``radii`` is a scalar eps or a (q,) vector."""
    r = torch.as_tensor(radii, dtype=centers.dtype, device=centers.device)
    return Within(centers=centers, radii=r.expand(centers.shape[0]).contiguous())


def intersects_box(lo: torch.Tensor, hi: torch.Tensor) -> IntersectsBox:
    return IntersectsBox(lo=lo, hi=hi)


def nearest(centers: torch.Tensor, k: int) -> Nearest:
    return Nearest(centers=centers, k=int(k))


def ray(origins: torch.Tensor, directions: torch.Tensor) -> Ray:
    return Ray(origins=origins, directions=directions)


def squared_radii(pred: Within) -> torch.Tensor:
    """r² per query, squared in float32 as the reference squares it."""
    r = pred.radii.to(torch.float32)
    return r * r


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def query_geometry(pred):
    """``(qa, qb, kind)``: the per-query arrays the traversal tests and the
    kernel's predicate name. ``Within``: centres and r²; ``IntersectsBox``:
    lo and hi; ``Ray``: origins and ``safe_inv(directions)``, computed once
    here, before any launch."""
    if isinstance(pred, Within):
        return _f32(pred.centers), squared_radii(pred), "sphere"
    if isinstance(pred, IntersectsBox):
        return _f32(pred.lo), _f32(pred.hi), "box"
    if isinstance(pred, Ray):
        return _f32(pred.origins), safe_inv(_f32(pred.directions)), "ray"
    raise TypeError("not a spatial predicate (Within, IntersectsBox or Ray): "
                    f"{type(pred).__name__}")


def _pred_centers(pred) -> torch.Tensor:
    if isinstance(pred, (Within, Nearest)):
        return pred.centers
    if isinstance(pred, IntersectsBox):
        return (pred.lo + pred.hi) * 0.5
    return pred.origins


class DeviceCsr(NamedTuple):
    """Device-resident CSR output. ``indices`` has ``capacity`` entries;
    ``total`` is the true hit count, a device scalar that may exceed
    ``capacity``, in which case ``overflowed`` is set and the surplus hits
    were dropped. ``offsets`` and ``total`` carry the caller's
    ``index_dtype``."""
    offsets: torch.Tensor     # (q+1,) index_dtype exclusive-scan row starts
    indices: torch.Tensor     # (capacity,) int32, -1 past ``total``
    total: torch.Tensor       # () index_dtype
    overflowed: torch.Tensor  # () bool


class BufferedCsr(NamedTuple):
    """Single-pass buffered CSR with observable retry behaviour."""
    offsets: torch.Tensor  # (q+1,) int32
    indices: torch.Tensor  # (total,) int32
    attempts: int          # passes taken (1 = zero-retry fast path)
    overflowed: bool       # whether any attempt overflowed


def _canon_index_dtype(index_dtype) -> torch.dtype:
    """Offsets are int32 or int64; any other dtype raises, as the
    reference's does."""
    if index_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"index_dtype must be int32 or int64, got "
                         f"{index_dtype}")
    return index_dtype


def _protocol_backend(backend: str) -> str:
    """The output protocols' backends; ``pair`` raises as the reference's
    protocols raise (its half-lists need a callback)."""
    if backend == "pair":
        raise ValueError("output protocols are per-query; the pair backend's "
                         "half-lists need a callback (use query(...))")
    if backend not in ("stackless", "pallas", "stack"):
        raise ValueError(f"unknown backend {backend!r} (use 'stackless', "
                         "'pallas' or 'stack')")
    return backend


def query_sort_permutation(bvh: Bvh, centers: torch.Tensor) -> torch.Tensor:
    """Morton-order permutation (int32) of query centers over the tree's
    root AABB; queries outside the scene clamp to the boundary bins."""
    unit = normalize_points(centers.to(torch.float32),
                            bvh.node_lo[0].to(torch.float32),
                            bvh.node_hi[0].to(torch.float32))
    return sort_by_morton32(morton32(unit)).to(torch.int32)


def _thread_order(bvh: Bvh, pred, sort_queries: bool,
                  order: torch.Tensor | None) -> torch.Tensor | None:
    if not sort_queries:
        return order
    if order is not None:
        raise ValueError("pass sort_queries=True or an order, not both")
    return query_sort_permutation(bvh, _pred_centers(pred))


# ---------------------------------------------------------------------------
# The stack backend of the protocols
# ---------------------------------------------------------------------------

def stack_traverse(bvh: Bvh, qa, qb, lanes, carry0, epilogue, *,
                   pred: str = "sphere", with_stats: bool = False):
    """The reference's ``_one_stack`` (``repro/core/query.py:212-245``) in
    lockstep over the query indices ``lanes``: each lane pops a node from
    its row of a ``(lanes, 96)`` int32 stack, tests it (``pred_test``),
    runs ``epilogue(carry, node, leaf_hit, value) -> (carry, done)`` (the
    contract of ``kernels.wavefront.lockstep_traverse``) and, at an
    internal node that is hit, pushes the right child, then the left, so
    the left pops first and leaves come in rope order. Returns the final
    carry per lane and the hops; ``with_stats`` adds the (6, m) int32
    counters of ``_one_stack_stats`` (``:312-353``): every iteration,
    internal and leaf iterations, leaf hits, whether the epilogue ended
    the walk, and the stack's high-water mark."""
    n, m, dev = bvh.num_leaves, lanes.numel(), lanes.device
    left, right = bvh.left_child.long(), bvh.right_child.long()
    stack = torch.full((m, STACK_DEPTH), SENTINEL, dtype=torch.int32,
                       device=dev)
    stack[:, 0] = 0
    out = carry0.clone()
    if with_stats:
        stats = torch.zeros((6, m), dtype=torch.int32, device=dev)
        stats[5] = 1
    pos = torch.arange(m, device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    carry, a, b = carry0, qa[lanes], qb[lanes]
    hops = 0
    while pos.numel():
        hops += pos.numel()
        sp = sp - 1
        node = stack[pos, sp].long()
        val, hit = pred_test(pred, a, b, bvh.node_lo[node], bvh.node_hi[node])
        is_leaf = node >= n - 1
        carry, done = epilogue(carry, node, is_leaf & hit, val)
        push = torch.nonzero(hit & ~is_leaf).flatten()
        nc, row, top = node[push], pos[push], sp[push]
        stack[row, top] = right[nc].to(torch.int32)
        stack[row, top + 1] = left[nc].to(torch.int32)
        sp[push] += 2
        if with_stats:
            stats[:4, pos] += torch.stack([torch.ones_like(hit), ~is_leaf,
                                           is_leaf, is_leaf & hit]).int()
            stats[5, pos] = torch.maximum(stats[5, pos], sp.int())
        live = (sp > 0) & ~done
        fin = ~live
        out[pos[fin]] = carry[fin]
        if with_stats:
            stats[4, pos[fin]] = done[fin].int()
        pos, sp, carry = pos[live], sp[live], carry[live]
        a, b = a[live], b[live]
    return (out, hops, stats) if with_stats else (out, hops)


# ---------------------------------------------------------------------------
# Output protocols
# ---------------------------------------------------------------------------

def query_count(bvh: Bvh, predicates, *, stop_at: int | None = None,
                backend: str = "stackless", sort_queries: bool = False,
                order: torch.Tensor | None = None, with_stats: bool = False,
                start_nodes: torch.Tensor | None = None):
    """Per-query intersection counts (int32). ``stop_at`` enables early
    termination: counting stops, and saturates, at ``stop_at``.
    ``start_nodes`` (int32 node per query, ``SENTINEL``: no walk; stackless
    and pallas only) replaces the root. ``with_stats=True`` returns
    ``(counts, TraversalStats)``, in query order whatever the thread
    order."""
    backend = _protocol_backend(backend)
    qa, qb, kind = query_geometry(predicates)
    if backend == "stack":
        if start_nodes is not None:
            raise ValueError("start_nodes is a stackless/pair-backend feature")
        lanes = torch.arange(qa.shape[0], device=qa.device)
        zeros = torch.zeros(qa.shape[0], dtype=torch.int32, device=qa.device)
        res = stack_traverse(bvh, qa, qb, lanes, zeros,
                             count_epilogue(stop_at), pred=kind,
                             with_stats=with_stats)
        return (res[0], TraversalStats.from_rows(res[2])) if with_stats \
            else res[0]
    if start_nodes is not None:
        start_nodes = start_nodes.to(device=qa.device,
                                     dtype=torch.int32).contiguous()
    res = wavefront_count(bvh, qa, qb, pred=kind, stop_at=stop_at,
                          order=_thread_order(bvh, predicates, sort_queries,
                                              order),
                          start=start_nodes,
                          depths=node_depths(bvh) if with_stats else None)
    if not with_stats:
        return res
    return res[0], TraversalStats.from_rows(res[1])


def query_fixed(bvh: Bvh, predicates, capacity: int, *,
                backend: str = "stackless", sort_queries: bool = False,
                order: torch.Tensor | None = None):
    """Single-pass fixed-capacity output: per-query index buffers
    ``(q, capacity)`` int32 (-1 padded; surplus hits overwrite the last
    slot), true counts ``(q,)`` int32, and the overflow flag
    ``any(counts > capacity)`` as a device scalar."""
    backend = _protocol_backend(backend)
    qa, qb, kind = query_geometry(predicates)
    if backend == "stack":
        buf = torch.full((qa.shape[0], capacity), -1, dtype=torch.int32,
                         device=qa.device)
        lanes, carry0 = fixed_carry(qa.shape[0], qa.device)
        carry = stack_traverse(bvh, qa, qb, lanes, carry0,
                               fixed_epilogue(bvh, buf), pred=kind)[0]
        counts = carry[:, 0].to(torch.int32)
    else:
        buf, counts = wavefront_fixed(
            bvh, qa, qb, capacity, pred=kind,
            order=_thread_order(bvh, predicates, sort_queries, order))
    return buf, counts, (counts > capacity).any()


def _exclusive_scan(counts: torch.Tensor, idx_dt: torch.dtype) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=idx_dt, device=counts.device),
                      torch.cumsum(counts, 0, dtype=idx_dt)])


def _compact_csr(buf: torch.Tensor, counts: torch.Tensor,
                 index_dtype=torch.int32):
    """Per-query buffers ``(q, cap)`` into CSR ``(offsets, indices)``:
    slot ``s`` of row ``i`` goes to ``offsets[i] + s`` for ``s <
    counts[i]``; positions no slot reaches stay -1. One host sync sizes
    ``indices``."""
    idx_dt = _canon_index_dtype(index_dtype)
    q, cap = buf.shape
    offsets = _exclusive_scan(counts, idx_dt)
    total = int(offsets[-1]) if q else 0
    slots = torch.arange(cap, device=buf.device)
    rows, cols = (slots[None, :] < counts[:, None]).nonzero(as_tuple=True)
    indices = torch.full((total,), -1, dtype=torch.int32, device=buf.device)
    indices[offsets[rows].long() + cols] = buf[rows, cols]
    return offsets, indices


def query_csr_device(bvh: Bvh, predicates, capacity: int, *,
                     counts: torch.Tensor | None = None, chunk: int = 32,
                     backend: str = "stackless", sort_queries: bool = False,
                     index_dtype=torch.int32,
                     order: torch.Tensor | None = None) -> DeviceCsr:
    """Device-resident count-then-fill CSR (the ArborX 2.0 backbone):
    pass 1 counts per predicate, an exclusive scan gives the offsets, and
    pass 2 writes hits at ``offsets[q] + k`` into one buffer of
    ``capacity`` entries. Nothing between the passes waits on the device.
    Hits past ``capacity`` are dropped and flagged. ``counts`` reuses a
    count pass the caller ran. ``chunk`` is the reference's fill-round
    size; the port's fill pass (the reference's ``_csr_fill``) is one
    traversal, so it changes no result."""
    del chunk
    backend = _protocol_backend(backend)
    idx_dt = _canon_index_dtype(index_dtype)
    capacity = max(int(capacity), 0)
    order = _thread_order(bvh, predicates, sort_queries, order)
    if counts is None:
        counts = query_count(bvh, predicates, backend=backend, order=order)
    offsets = _exclusive_scan(counts, idx_dt)
    qa, qb, kind = query_geometry(predicates)
    if backend == "stack":
        indices = torch.full((capacity,), -1, dtype=torch.int32,
                             device=qa.device)
        lanes, first = fill_lanes(offsets, capacity)
        stack_traverse(bvh, qa, qb, lanes, first, fill_epilogue(bvh, indices),
                       pred=kind)
    else:
        indices = wavefront_fill(bvh, qa, qb, offsets, capacity, pred=kind,
                                 order=order)
    total = offsets[-1]
    return DeviceCsr(offsets=offsets, indices=indices, total=total,
                     overflowed=total > capacity)


def query_csr(bvh: Bvh, predicates, *, capacity: int | None = None,
              chunk: int = 32, backend: str = "stackless",
              sort_queries: bool = False, index_dtype=torch.int32,
              order: torch.Tensor | None = None) -> DeviceCsr:
    """Count-then-fill CSR output. With ``capacity`` given this is
    :func:`query_csr_device`. With ``capacity=None`` one host sync reads
    the exact total, which sizes ``indices``; ``overflowed`` is then
    False."""
    order = _thread_order(bvh, predicates, sort_queries, order)
    if capacity is not None:
        return query_csr_device(bvh, predicates, capacity, chunk=chunk,
                                backend=backend, index_dtype=index_dtype,
                                order=order)
    counts = query_count(bvh, predicates, backend=backend, order=order)
    exact = int(counts.sum(dtype=torch.int64)) if counts.shape[0] else 0
    return query_csr_device(bvh, predicates, exact, counts=counts, chunk=chunk,
                            backend=backend, index_dtype=index_dtype,
                            order=order)


def query_csr_buffered(bvh: Bvh, predicates, *, capacity: int = 8,
                       max_doublings: int = 16, backend: str = "stackless",
                       sort_queries: bool = False,
                       order: torch.Tensor | None = None) -> BufferedCsr:
    """Single-pass CSR with the buffer optimization: fill fixed per-query
    buffers of ``capacity``; if any query overflows, double and retry. Each
    retry decision is a host sync. ``attempts == 1`` is the zero-retry fast
    path; ``overflowed`` says whether any pass overflowed."""
    order = _thread_order(bvh, predicates, sort_queries, order)
    cap = max(int(capacity), 1)
    overflowed_any = False
    for attempt in range(1, max_doublings + 2):
        buf, counts, overflow = query_fixed(bvh, predicates, cap,
                                            backend=backend, order=order)
        if not bool(overflow):
            offsets, indices = _compact_csr(buf, counts)
            return BufferedCsr(offsets=offsets, indices=indices,
                               attempts=attempt, overflowed=overflowed_any)
        del buf, counts  # the next, doubled buffer must not sit beside it
        overflowed_any = True
        cap *= 2
    raise RuntimeError(f"query_csr_buffered: still overflowing at capacity {cap}")


# ---------------------------------------------------------------------------
# The generic engine: arbitrary callbacks, in torch ops
# ---------------------------------------------------------------------------

def _tmap(fn, tree, *rest):
    """``fn`` over the tensors of a pytree of tuples, NamedTuples, lists
    and dicts (and of trees of the same structure beside it)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tmap(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: _tmap(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _tleaves(tree) -> list:
    out = []
    _tmap(out.append, tree)
    return out


def _take(tree, idx):
    return _tmap(lambda x: x[idx], tree)


def _put(tree, idx, new) -> None:
    def put(x, v):
        x[idx] = v
    _tmap(put, tree, new)


def _select(mask: torch.Tensor, a, b):
    """Per lane, ``a`` where ``mask`` else ``b`` (pytrees of (m, ...))."""
    return _tmap(lambda x, y: torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def _as_done(done, m: int, device) -> torch.Tensor:
    if isinstance(done, torch.Tensor):
        return done.to(device=device, dtype=torch.bool).expand(m)
    return torch.full((m,), bool(done), dtype=torch.bool, device=device)


def _broadcast_carries(carry_init, q: int, device):
    def rows(x):
        x = torch.as_tensor(x, device=device)
        return x.expand((q,) + tuple(x.shape)).clone()
    return _tmap(rows, carry_init)


def _walk(bvh: Bvh, qdata, node_fn, leaf_fn, carries, *, stack: bool,
          start=None, depths=None):
    """The generic lockstep walk behind :func:`traverse`: the reference's
    ``_one_stackless``/``_one_stack`` (and their stats twins) over every
    query at once. A leaf lane runs ``leaf_fn``, an internal lane
    ``node_fn``; the rope walk follows ``left_child`` on a hit and the rope
    otherwise, the stack walk pushes right then left. Returns the carries
    and the (6, q) counters (stack: the stack's high-water mark as the
    depth; stackless: the deepest node from ``depths``)."""
    n = bvh.num_leaves
    q = _tleaves(qdata)[0].shape[0]
    dev = bvh.left_child.device
    left, right, rope = (bvh.left_child.long(), bvh.right_child.long(),
                         bvh.rope.long())
    leaf_perm = bvh.leaf_perm
    out = carries
    stats = torch.zeros((6, q), dtype=torch.int32, device=dev)
    pos = torch.arange(q, device=dev)
    if stack:
        stk = torch.full((q, STACK_DEPTH), SENTINEL, dtype=torch.int64,
                         device=dev)
        stk[:, 0] = 0
        sp = torch.ones(q, dtype=torch.int64, device=dev)
        stats[5] = 1
    else:
        node = (torch.zeros(q, dtype=torch.int64, device=dev) if start is None
                else start.to(device=dev, dtype=torch.int64))
        pos = pos[node != SENTINEL]
        node = node[pos]
    qd, carry = _take(qdata, pos), _take(carries, pos)
    while pos.numel():
        m = pos.numel()
        if stack:
            sp = sp - 1
            node = stk[pos, sp]
        is_leaf = node >= n - 1
        lf = torch.nonzero(is_leaf).flatten()
        inner = torch.nonzero(~is_leaf).flatten()
        done = torch.zeros(m, dtype=torch.bool, device=dev)
        hit = torch.zeros(m, dtype=torch.bool, device=dev)
        if lf.numel():
            sorted_idx = node[lf] - (n - 1)
            new, d = leaf_fn(_take(qd, lf), _take(carry, lf),
                             leaf_perm[sorted_idx], sorted_idx.to(torch.int32))
            _put(carry, lf, new)
            done[lf] = _as_done(d, lf.numel(), dev)
        if inner.numel():
            hit[inner] = node_fn(_take(qd, inner), _take(carry, inner),
                                 node[inner].to(torch.int32)).to(torch.bool)
        stats[:3, pos] += torch.stack([torch.ones_like(is_leaf), ~is_leaf,
                                       is_leaf]).int()
        if stack:
            push = torch.nonzero(hit).flatten()
            row, top, nc = pos[push], sp[push], node[push]
            stk[row, top] = right[nc]
            stk[row, top + 1] = left[nc]
            sp[push] += 2
            stats[5, pos] = torch.maximum(stats[5, pos], sp.int())
            live = (sp > 0) & ~done
        else:
            if depths is not None:
                stats[5, pos] = torch.maximum(stats[5, pos], depths[node])
            node = torch.where(hit, left[node.clamp(max=max(n - 2, 0))],
                               rope[node])
            live = (node != SENTINEL) & ~done
        fin = torch.nonzero(~live).flatten()
        _put(out, pos[fin], _take(carry, fin))
        stats[4, pos[fin]] = done[fin].int()
        keep = torch.nonzero(live).flatten()
        pos, qd, carry = pos[keep], _take(qd, keep), _take(carry, keep)
        if stack:
            sp = sp[keep]
        else:
            node = node[keep]
    return out, stats


def traverse(bvh: Bvh, qdata, node_fn: Callable, leaf_fn: Callable,
             carry_init, *, backend: str = "stackless",
             start_nodes: torch.Tensor | None = None,
             with_stats: bool = False):
    """Generic batched traversal, the reference's ``traverse``
    (``repro/core/query.py:371-426``) in torch ops on the tree's device.

    ``qdata``: a pytree of per-query tensors (leading dim q).
    ``node_fn(q, carry, node) -> (m,) bool`` decides descent at internal
    nodes; ``leaf_fn(q, carry, obj_idx, sorted_idx) -> (carry, done)``
    runs on every reached leaf. Both take lane batches: ``q`` and
    ``carry`` hold the rows of the m lanes at such a node, ``node``,
    ``obj_idx`` and ``sorted_idx`` are (m,) int32; ``done`` is a Python
    bool or an (m,) bool tensor. ``carry_init`` (a pytree of tensors or
    scalars) is broadcast to one carry per query. ``backend``:
    ``stackless`` (with ``start_nodes``) or ``stack``. ``with_stats=True``
    returns ``(carries, TraversalStats)``; ``callback_hits`` is zero here
    (the engine protocols fill it in)."""
    leaves = _tleaves(qdata)
    if not leaves:
        raise ValueError("qdata must contain at least one per-query array")
    if backend == "pallas":
        raise ValueError(
            "backend='pallas' is dispatched by the engine entry points "
            "(query/query_count/query_csr_device/...), not the generic "
            "traverse driver")
    if backend not in ("stackless", "stack"):
        raise ValueError(f"unknown backend {backend!r} (use 'stackless' or "
                         "'stack')")
    if backend == "stack" and start_nodes is not None:
        raise ValueError("start_nodes is a stackless/pair-backend feature")
    carries = _broadcast_carries(carry_init, leaves[0].shape[0],
                                 bvh.left_child.device)
    out, rows = _walk(bvh, qdata, node_fn, leaf_fn, carries,
                      stack=backend == "stack", start=start_nodes,
                      depths=node_depths(bvh) if with_stats else None)
    if not with_stats:
        return out
    rows[3] = 0
    return out, TraversalStats.from_rows(rows)


def traverse_nearest_stack(bvh: Bvh, centers: torch.Tensor, qdata,
                           push_fn: Callable, leaf_fn: Callable, carry_init):
    """Distance-ordered stack traversal, the nearest-search substrate
    (``repro/core/query.py:429-484``), in torch ops on the tree's device:
    children are pushed far first, so the near child is explored first;
    ``push_fn(q, carry, child, d2_child) -> (m,) bool`` gates each push
    against the carry, ``leaf_fn(q, carry, obj_idx, d2_leaf) -> carry``
    updates it at a leaf. Both take lane batches: ``q`` and ``carry`` hold
    the rows of the m lanes at such a node (``qdata`` a pytree of
    per-query tensors), ``child`` and ``obj_idx`` are (m,) int32, ``d2``
    (m,) float32. ``carry_init`` is broadcast to one carry per query. A
    popped node is not tested again against the tightened bound, as in
    the reference. The fixed walks of KNN, EMST and rays run as the CUDA
    kernel of ``kernels/nearest.py``."""
    q = centers.shape[0]
    carries = _broadcast_carries(carry_init, q, centers.device)

    def rebuild(flat):
        it = iter(flat)
        return _tmap(lambda _x: next(it), carries)

    def push(lanes, carry, child, d2):
        return push_fn(_take(qdata, lanes), rebuild(carry), child,
                       d2).to(torch.bool)

    def leaf(lanes, carry, obj, d2):
        return tuple(_tleaves(leaf_fn(_take(qdata, lanes), rebuild(carry),
                                      obj, d2)))

    out, _ = ordered_stack_walk(bvh, _f32(centers), tuple(_tleaves(carries)),
                                push, leaf)
    return rebuild(out)


def node_reduce(bvh: Bvh, leaf_values, combine: Callable, identity):
    """Bottom-up per-node reduction (``repro/core/query.py:487-523``): a
    pytree of (2n-1, ...) node values where leaf node ``(n-1)+k`` holds
    ``leaf_values[k]`` (sorted leaf order) and each internal node
    ``combine(left, right)``, batched over the nodes whose children are
    ready, round after round, as the reference's fixpoint."""
    n = bvh.num_leaves
    dev = bvh.left_child.device

    def seed(ident, lv):
        lv = torch.as_tensor(lv, device=dev)
        ident = torch.as_tensor(ident, dtype=lv.dtype, device=dev)
        rows = ident.expand((n - 1,) + tuple(ident.shape))
        return torch.cat([rows, lv])

    vals = _tmap(seed, identity, leaf_values)
    ready = torch.cat([torch.zeros(n - 1, dtype=torch.bool, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev)])
    left, right = bvh.left_child.long(), bvh.right_child.long()
    pending = torch.arange(n - 1, device=dev)
    while pending.numel():
        ok = ready[left[pending]] & ready[right[pending]]
        done = pending[ok]
        new = combine(_take(vals, left[done]), _take(vals, right[done]))
        _put(vals, done, new)
        ready[done] = True
        pending = pending[~ok]
    return vals


def _spatial_query(bvh, pred, callback, carry_init, backend, with_stats,
                   start_nodes, pair: bool = False):
    qa, qb, kind = query_geometry(pred)
    q = qa.shape[0]
    if pair:
        # Query k = sorted point k; its query_idx is the original leaf_perm[k].
        perm = bvh.leaf_perm
        qdata = (perm, qa[perm.long()], qb[perm.long()])
        start_nodes = pair_starts(bvh)
    else:
        qdata = (torch.arange(q, dtype=torch.int32, device=qa.device), qa, qb)
    n = bvh.num_leaves

    def node_fn(qd, _carry, node):
        return pred_test(kind, qd[1], qd[2], bvh.node_lo[node],
                         bvh.node_hi[node])[1]

    def fused(qd, carry, obj, sorted_idx):
        """Run the predicate's leaf test; the callback's carry counts only
        on hits, and only a hit can end the walk."""
        leaf = sorted_idx.long() + (n - 1)
        val, hit = pred_test(kind, qd[1], qd[2], bvh.node_lo[leaf],
                             bvh.node_hi[leaf])
        user = carry[0] if with_stats else carry
        new, done = callback(user, qd[0], obj, val)
        new = _select(hit, new, user)
        done = hit & _as_done(done, hit.numel(), hit.device)
        if with_stats:
            return (new, carry[1] + hit.int()), done
        return new, done

    init = (carry_init, torch.zeros((), dtype=torch.int32)) if with_stats \
        else carry_init
    res = traverse(bvh, qdata, node_fn, fused, init, backend=backend,
                   start_nodes=start_nodes, with_stats=with_stats)
    if not with_stats:
        return res
    (out, hits), stats = res
    return out, stats._replace(callback_hits=hits)


def _pair_query(bvh, pred, callback, carry_init, with_stats=False):
    """Pair traversal (§4.2.3): ``pred`` must be ``within`` over the very
    points the tree indexes. Query k starts at ``rope[leaf k]`` and visits
    exactly the leaves after k in Morton order, each unordered pair once.
    Carries (and, with ``with_stats``, stats rows) come back in sorted
    order; row k belongs to original point ``bvh.leaf_perm[k]``, the
    ``query_idx`` the callback gets."""
    if not isinstance(pred, Within):
        raise TypeError("backend='pair' requires a within(...) predicate over "
                        "the indexed points")
    n = bvh.num_leaves
    if pred.centers.shape[0] != n:
        raise ValueError(
            f"backend='pair' is a self-join: the predicate must cover exactly "
            f"the {n} indexed points, got {pred.centers.shape[0]} queries")
    return _spatial_query(bvh, pred, callback, carry_init, "stackless",
                          with_stats, None, pair=True)


def _nearest_batched(bvh: Bvh, centers: torch.Tensor, k: int,
                     order: torch.Tensor | None = None) -> NearestResult:
    """kNN by the Euclidean distance to leaf boxes (the points, for point
    leaves): the ordered stack with a bounded, unsorted candidate buffer
    (``repro/core/query.py:767-791``), as the KNN epilogue of the nearest
    kernel on the card."""
    idx, dist = nearest_knn(bvh, _f32(centers), k, order=order)
    return NearestResult(indices=idx, distances=dist)


def _nearest_query(bvh, pred: Nearest, callback, carry_init, order):
    """``repro/core/query.py:794-825``. Without a callback the
    ``NearestResult``; with one, the callback runs per result in ascending
    distance, with the Euclidean distance (spatial callbacks get d²), on
    lane batches of the queries still running: a result slot is skipped
    where it is unfilled (-1) or the query is done."""
    res = _nearest_batched(bvh, pred.centers, pred.k, order)
    if callback is None:
        return res
    q, dev = pred.centers.shape[0], res.indices.device
    carries = _broadcast_carries(carry_init, q, dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    qidx = torch.arange(q, dtype=torch.int32, device=dev)
    for i in range(pred.k):
        lanes = torch.nonzero((res.indices[:, i] >= 0) & ~done).flatten()
        if not lanes.numel():
            continue
        new, d = callback(_take(carries, lanes), qidx[lanes],
                          res.indices[lanes, i], res.distances[lanes, i])
        _put(carries, lanes, new)
        done[lanes] |= _as_done(d, lanes.numel(), dev)
    return carries


def _ray_query(bvh, pred: Ray, order) -> RayResult:
    """The nearest-hit protocol (``repro/core/query.py:844-900``): the RAY
    epilogue of the nearest kernel on the card."""
    idx, t = nearest_ray(bvh, _f32(pred.origins),
                         safe_inv(_f32(pred.directions)), order=order)
    return RayResult(index=idx, t=t)


def query(bvh: Bvh, predicates, callback: Callable | None = None,
          carry_init=None, *, backend: str = "stackless",
          sort_queries: bool = False, with_stats: bool = False,
          start_nodes: torch.Tensor | None = None):
    """The single entry point (``repro/core/query.py:903-971``): dispatch
    ``predicates`` against the tree, fusing ``callback`` into the
    traversal, in torch ops on the tree's device (see the module notes for
    the callback's lane batches).

    * ``Within`` / ``IntersectsBox`` + callback -> per-query final
      carries; the callback's last argument is the squared distance.
    * ``Ray`` + callback -> the all-intersections protocol: the callback
      fires per leaf volume the ray pierces, with the entry parameter
      ``t`` in the last argument.
    * ``Nearest`` -> ``NearestResult``, or with a callback the carries of
      :func:`_nearest_query`'s protocol (any ``backend``: the nearest walk
      is its own, as the reference's).
    * ``Ray`` without a callback -> ``RayResult``, the nearest hit.

    ``backend``: ``stackless`` (``pallas`` is the same walk), ``stack`` or
    ``pair`` (a ``within`` self-join; carries in sorted leaf order, see
    :func:`_pair_query`). ``sort_queries`` makes the nearest kernel's
    threads take queries in Morton order; it changes no result, and the
    torch walks ignore it (the pair backend refuses it, as the
    reference's does). ``with_stats=True`` returns
    ``(result, TraversalStats)``. ``start_nodes`` (stackless) replaces the
    root."""
    nearest_protocol = isinstance(predicates, Nearest) or (
        isinstance(predicates, Ray) and callback is None)
    if with_stats and nearest_protocol:
        raise ValueError(
            "with_stats instruments the spatial traversal cores; the "
            "nearest / nearest-hit-ray protocols run on the priority-queue "
            "substrate, which has no stats threading")
    if start_nodes is not None and (nearest_protocol or backend == "pair"):
        raise ValueError(
            "start_nodes applies to the spatial stackless/pallas traversals; "
            "the nearest protocols have their own ordering and the pair "
            "backend derives its own start nodes")
    if nearest_protocol:
        order = _thread_order(bvh, predicates, sort_queries, None)
        if isinstance(predicates, Nearest):
            return _nearest_query(bvh, predicates, callback, carry_init, order)
        return _ray_query(bvh, predicates, order)
    if isinstance(predicates, Ray) and backend == "pair":
        raise ValueError("backend='pair' is a within() self-join")
    if not isinstance(predicates, (Within, IntersectsBox, Ray)):
        raise TypeError(f"unknown predicate type {type(predicates).__name__}")
    if callback is None:
        raise ValueError("spatial predicates need a callback; use "
                         "query_count/query_csr for built-in output protocols")
    if backend == "pair":
        if sort_queries:
            raise ValueError("backend='pair' queries are inherently "
                             "Morton-sorted; sort_queries does not apply")
        return _pair_query(bvh, predicates, callback, carry_init, with_stats)
    if backend == "pallas":
        backend = "stackless"
    return _spatial_query(bvh, predicates, callback, carry_init, backend,
                          with_stats, start_nodes)
