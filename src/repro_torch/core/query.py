"""Spatial queries; port of ``repro/core/query.py`` (``Within`` predicates:
``query_count`` with ``with_stats`` and ``start_nodes``,
``query_sort_permutation``, ``node_depths``, and the neighbor-list output
protocols ``query_fixed``, ``query_csr_device``, ``query_csr`` and
``query_csr_buffered`` with ``DeviceCsr`` and ``BufferedCsr``).

Every ε-query runs the rope traversal of
``repro_torch.kernels.wavefront``: the CUDA kernel on the card, its plain
lockstep version on the CPU. ``IntersectsBox``, the ``stack`` backend and
the generic callback ``query`` are not ported yet (ROADMAP A8); a
protocol given another predicate raises ``TypeError``.

Every protocol takes the reference's ``sort_queries=``: the Morton
permutation of the query centers becomes the order in which the kernel's
threads take queries (``order``), which changes no result. A caller that
already knows a good order, such as ``bvh.leaf_perm`` for a self-join,
passes it as ``order`` instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bvh import Bvh
from repro_torch.core.morton import morton32, normalize_points, sort_by_morton32
from repro_torch.kernels.wavefront import (wavefront_count, wavefront_fill,
                                           wavefront_fixed)
from repro_torch.obs.stats import TraversalStats

__all__ = ["Within", "within", "squared_radii", "query_sort_permutation",
           "node_depths", "query_count", "DeviceCsr", "BufferedCsr",
           "query_fixed", "query_csr_device", "query_csr",
           "query_csr_buffered"]


class Within(NamedTuple):
    """ε-sphere predicates: all objects within ``radii`` of ``centers``."""
    centers: torch.Tensor  # (q, 3) float32
    radii: torch.Tensor    # (q,) float32


def within(centers: torch.Tensor, radii) -> Within:
    """Sphere predicate; ``radii`` is a scalar eps or a (q,) vector."""
    r = torch.as_tensor(radii, dtype=centers.dtype, device=centers.device)
    return Within(centers=centers, radii=r.expand(centers.shape[0]).contiguous())


def squared_radii(pred: Within) -> torch.Tensor:
    """r² per query, squared in float32 as the reference squares it."""
    r = pred.radii.to(torch.float32)
    return r * r


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


def _within(predicates) -> Within:
    if not isinstance(predicates, Within):
        raise TypeError("the port's spatial protocols take Within predicates")
    return predicates


def query_sort_permutation(bvh: Bvh, centers: torch.Tensor) -> torch.Tensor:
    """Morton-order permutation (int32) of query centers over the tree's
    root AABB; queries outside the scene clamp to the boundary bins."""
    unit = normalize_points(centers.to(torch.float32),
                            bvh.node_lo[0].to(torch.float32),
                            bvh.node_hi[0].to(torch.float32))
    return sort_by_morton32(morton32(unit)).to(torch.int32)


def _thread_order(bvh: Bvh, pred: Within, sort_queries: bool,
                  order: torch.Tensor | None) -> torch.Tensor | None:
    if not sort_queries:
        return order
    if order is not None:
        raise ValueError("pass sort_queries=True or an order, not both")
    return query_sort_permutation(bvh, pred.centers)


def _geometry(pred: Within):
    return pred.centers.contiguous(), squared_radii(pred)


def node_depths(bvh: Bvh) -> torch.Tensor:
    """(2n-1,) int32 depth of every node, the root at 0; the table of
    ``_node_depths`` (``repro/core/query.py:257-271``). The reference
    propagates depths top-down for a fixed 96 levels, the most a tree of
    64 code bits and 32 index bits can have; here one level at a time
    until the last, which gives the same table."""
    n = bvh.num_leaves
    depth = torch.zeros(2 * n - 1, dtype=torch.int32,
                        device=bvh.left_child.device)
    level = torch.zeros(1, dtype=torch.int64, device=depth.device)
    d = 0
    while level.numel():
        d += 1
        kids = torch.cat([bvh.left_child[level], bvh.right_child[level]]).long()
        depth[kids] = d
        level = kids[kids < n - 1]
    return depth


def query_count(bvh: Bvh, predicates: Within, *, stop_at: int | None = None,
                sort_queries: bool = False,
                order: torch.Tensor | None = None, with_stats: bool = False,
                start_nodes: torch.Tensor | None = None):
    """Per-query intersection counts (int32). ``stop_at`` enables early
    termination: counting stops, and saturates, at ``stop_at``.
    ``start_nodes`` (int32 node per query, ``SENTINEL``: no walk) replaces
    the root. ``with_stats=True`` returns ``(counts, TraversalStats)``, in
    query order whatever the thread order."""
    pred = _within(predicates)
    if start_nodes is not None:
        start_nodes = start_nodes.to(device=pred.centers.device,
                                     dtype=torch.int32).contiguous()
    res = wavefront_count(bvh, *_geometry(pred), stop_at=stop_at,
                          order=_thread_order(bvh, pred, sort_queries, order),
                          start=start_nodes,
                          depths=node_depths(bvh) if with_stats else None)
    if not with_stats:
        return res
    return res[0], TraversalStats.from_rows(res[1])


def query_fixed(bvh: Bvh, predicates: Within, capacity: int, *,
                sort_queries: bool = False,
                order: torch.Tensor | None = None):
    """Single-pass fixed-capacity output: per-query index buffers
    ``(q, capacity)`` int32 (-1 padded; surplus hits overwrite the last
    slot), true counts ``(q,)`` int32, and the overflow flag
    ``any(counts > capacity)`` as a device scalar."""
    pred = _within(predicates)
    buf, counts = wavefront_fixed(
        bvh, *_geometry(pred), capacity,
        order=_thread_order(bvh, pred, sort_queries, order))
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


def query_csr_device(bvh: Bvh, predicates: Within, capacity: int, *,
                     counts: torch.Tensor | None = None, chunk: int = 32,
                     sort_queries: bool = False,
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
    pred = _within(predicates)
    idx_dt = _canon_index_dtype(index_dtype)
    capacity = max(int(capacity), 0)
    order = _thread_order(bvh, pred, sort_queries, order)
    if counts is None:
        counts = query_count(bvh, pred, order=order)
    offsets = _exclusive_scan(counts, idx_dt)
    indices = wavefront_fill(bvh, *_geometry(pred), offsets, capacity,
                             order=order)
    total = offsets[-1]
    return DeviceCsr(offsets=offsets, indices=indices, total=total,
                     overflowed=total > capacity)


def query_csr(bvh: Bvh, predicates: Within, *, capacity: int | None = None,
              chunk: int = 32, sort_queries: bool = False,
              index_dtype=torch.int32,
              order: torch.Tensor | None = None) -> DeviceCsr:
    """Count-then-fill CSR output. With ``capacity`` given this is
    :func:`query_csr_device`. With ``capacity=None`` one host sync reads
    the exact total, which sizes ``indices``; ``overflowed`` is then
    False."""
    pred = _within(predicates)
    order = _thread_order(bvh, pred, sort_queries, order)
    if capacity is not None:
        return query_csr_device(bvh, pred, capacity, chunk=chunk,
                                index_dtype=index_dtype, order=order)
    counts = query_count(bvh, pred, order=order)
    exact = int(counts.sum(dtype=torch.int64)) if counts.shape[0] else 0
    return query_csr_device(bvh, pred, exact, counts=counts, chunk=chunk,
                            index_dtype=index_dtype, order=order)


def query_csr_buffered(bvh: Bvh, predicates: Within, *, capacity: int = 8,
                       max_doublings: int = 16, sort_queries: bool = False,
                       order: torch.Tensor | None = None) -> BufferedCsr:
    """Single-pass CSR with the buffer optimization: fill fixed per-query
    buffers of ``capacity``; if any query overflows, double and retry. Each
    retry decision is a host sync. ``attempts == 1`` is the zero-retry fast
    path; ``overflowed`` says whether any pass overflowed."""
    pred = _within(predicates)
    order = _thread_order(bvh, pred, sort_queries, order)
    cap = max(int(capacity), 1)
    overflowed_any = False
    for attempt in range(1, max_doublings + 2):
        buf, counts, overflow = query_fixed(bvh, pred, cap, order=order)
        if not bool(overflow):
            offsets, indices = _compact_csr(buf, counts)
            return BufferedCsr(offsets=offsets, indices=indices,
                               attempts=attempt, overflowed=overflowed_any)
        del buf, counts  # the next, doubled buffer must not sit beside it
        overflowed_any = True
        cap *= 2
    raise RuntimeError(f"query_csr_buffered: still overflowing at capacity {cap}")
