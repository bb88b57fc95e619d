"""Sharded geometric queries over a mesh of shards; port of
``repro/core/distributed.py`` (HACC's MPI domain decomposition).

The reference expresses each layer in ``shard_map`` with collectives; the
port runs the same shard bodies on a :class:`~repro_torch.core.mesh.ShardMesh`
(one thread per shard of one device), whose handle ``axis`` carries the
collectives. Every sharded consumer (distributed DBSCAN, the halo pipeline
in ``repro_torch.halos.merge``) shares one substrate:

  1. ``slab_partition``: host-side pre-partition, shard k owns the k-th
     contiguous slab along the first coordinate.
  2. ``halo_exchange``: the ε-ghost exchange. Each shard packs its boundary
     points (within ε of a slab face) into fixed-capacity buffers and ships
     them to the adjacent shards with ``ppermute``. The routes are fixed, so
     ``exchange_payload`` can later ship any per-point value (core flags,
     labels) along them without re-packing.
  3. ``shard_context``: per-shard trees, one over local ∪ ghost points
     (cross-shard queries) and one over local points only (local union
     rounds, SO counts). Invalid ghost rows are folded to a coordinate ≥ 4ε
     outside the local scene, so they never satisfy an ε-predicate and do
     not stretch the Morton normalization.
  4. ``sharded_query_csr`` / ``sharded_neighbor_csr``: cross-shard queries
     through the count-then-fill CSR protocol (``query_csr_device``), hit
     indices remapped to global point ids.
  5. ``dbscan_local_shard``: the per-shard DBSCAN body, callable inside any
     mesh body, so that ``halo_pipeline_sharded`` can fuse clustering with
     the catalog.
  6. ``dbscan_distributed``: the standalone entry point.

Labels are GLOBAL point ids (shard * n_local + slot) of ``index_dtype``,
int32 or int64; a cluster's root is the minimum global id in it, noise is
-1. The traversals are the wavefront kernel's COUNT, MIN_LABEL (its int64
instance for int64 labels) and FILL epilogues on the card, their plain
versions on the CPU. The reference's ``_jit_ok``/``_maybe_jit``/``_mesh_ref``
(an XLA:CPU workaround) have no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bvh import Bvh, build_bvh
from repro_torch.core.dbscan import count_neighbors, min_core_label_on, union_rounds
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.mesh import ShardAxis, ShardMesh
from repro_torch.core.query import (DeviceCsr, _canon_index_dtype,
                                    query_csr_device, within)
from repro_torch.device import as_tensor_on
from repro_torch.kernels.wavefront import shared_pack

__all__ = [
    "NOISE",
    "DistDbscanResult",
    "HaloExchange",
    "ShardContext",
    "ShardedCsr",
    "slab_partition",
    "halo_exchange",
    "exchange_payload",
    "shard_context",
    "sharded_query_csr",
    "sharded_neighbor_csr",
    "dbscan_local_shard",
    "dbscan_distributed",
]

NOISE = -1
BIG = 1e15


class DistDbscanResult(NamedTuple):
    labels: torch.Tensor         # (n_total,) global labels, index_dtype
    core_mask: torch.Tensor      # (n_total,) bool
    rounds: torch.Tensor         # () int32 global merge rounds
    halo_overflow: torch.Tensor  # () bool, halo capacity exceeded somewhere


class HaloExchange(NamedTuple):
    """Result of the ε-ghost exchange, with the fixed boundary routes kept
    so per-point payloads can be re-shipped later (``exchange_payload``)."""
    halo_pts: torch.Tensor    # (2H, d) ghost points; invalid rows folded ≥4ε out
    halo_valid: torch.Tensor  # (2H,) bool
    halo_gid: torch.Tensor    # (2H,) global ids (gid's dtype), -1 invalid
    overflow: torch.Tensor    # () bool, any shard overflowed its halo buffer
    lidx: torch.Tensor        # (H,) local rows packed for the LEFT neighbour
    lvalid: torch.Tensor      # (H,) bool
    ridx: torch.Tensor        # (H,) local rows packed for the RIGHT neighbour
    rvalid: torch.Tensor      # (H,) bool
    n_shards: int             # rebuilds the ppermute routes


class ShardContext(NamedTuple):
    """Per-shard sharded-query substrate (build once, query many). Global
    ids carry the caller's ``index_dtype``: int64 once ``n_shards * n_loc``
    can exceed 2^31."""
    gid: torch.Tensor       # (n_loc,) index_dtype global ids of local points
    exchange: HaloExchange
    all_pts: torch.Tensor   # (n_loc + 2H, d) local ∪ ghost
    all_gid: torch.Tensor   # (n_loc + 2H,) index_dtype, -1 on invalid ghost rows
    bvh_all: Bvh            # tree over local ∪ ghost (cross-shard queries)
    bvh_local: Bvh          # tree over local points only
    sentinel: torch.Tensor  # () index_dtype = n_shards * n_loc (> any global id)


class ShardedCsr(NamedTuple):
    """Cross-shard CSR: per-shard rows over LOCAL queries, global object
    ids (offsets/indices/total carry the caller's ``index_dtype``)."""
    offsets: torch.Tensor     # (S, n_loc+1) per-shard row starts
    indices: torch.Tensor     # (S, capacity) GLOBAL point ids, -1 padded
    total: torch.Tensor       # (S,) hits per shard
    overflowed: torch.Tensor  # () bool, any shard exceeded ``capacity``


def slab_partition(points: np.ndarray, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side pre-partition: sort by x and split into equal slabs (HACC
    ranks own spatial subvolumes). Returns (points_sorted, orig_index)."""
    order = np.argsort(points[:, 0], kind="stable")
    return points[order], order


def _pack_boundary(pts: torch.Tensor, mask: torch.Tensor, cap: int):
    """Pack masked rows into a fixed (min(n, cap), d) buffer, masked rows
    first in row order; returns the buffer, the rows, their validity and
    whether the mask held more than ``cap`` rows."""
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    idx = order[:cap]
    valid = mask[idx]
    buf = torch.where(valid[:, None], pts[idx], BIG)
    return buf, idx, valid, mask.sum(dtype=torch.int32) > cap


def _perms(n_shards: int):
    right_perm = [(i, i + 1) for i in range(n_shards - 1)]
    left_perm = [(i + 1, i) for i in range(n_shards - 1)]
    return right_perm, left_perm


def _xchg(axis: ShardAxis, n_shards: int, val_r, val_l):
    """Send ``val_r`` to the right neighbour, ``val_l`` to the left. Shards
    with no sender (slab edges) receive ZEROS, so every exchanged payload
    is decoded through a validity mask (or 0-means-absent encoding)."""
    right_perm, left_perm = _perms(n_shards)
    from_left = axis.ppermute(val_r, right_perm)
    from_right = axis.ppermute(val_l, left_perm)
    return from_left, from_right


def halo_exchange(pts: torch.Tensor, gid: torch.Tensor, eps, halo_cap: int,
                  axis: ShardAxis) -> HaloExchange:
    """The ε-ghost exchange (call inside a mesh body): ship boundary points
    and their global ids to the adjacent shards along fixed routes.

    Invalid ghost rows (slab-edge fill, overflow padding) are folded to a
    point ≥ 4ε beyond the per-axis max of every real point this shard can
    see, so downstream ε-queries never match them."""
    n_shards = axis.size
    eps = torch.tensor(float(eps), dtype=pts.dtype, device=pts.device)
    lo_x = pts[:, 0].min()
    hi_x = pts[:, 0].max()
    left_mask = pts[:, 0] <= lo_x + eps
    right_mask = pts[:, 0] >= hi_x - eps
    lbuf, lidx, lvalid, lovf = _pack_boundary(pts, left_mask, halo_cap)
    rbuf, ridx, rvalid, rovf = _pack_boundary(pts, right_mask, halo_cap)

    halo_l_pts, halo_r_pts = _xchg(axis, n_shards, rbuf, lbuf)
    # gid encoded +1 so the zero-fill at slab edges decodes to 'absent'.
    lgid_enc = torch.where(lvalid, gid[lidx] + 1, 0)
    rgid_enc = torch.where(rvalid, gid[ridx] + 1, 0)
    halo_l_enc, halo_r_enc = _xchg(axis, n_shards, rgid_enc, lgid_enc)
    halo_enc = torch.cat([halo_l_enc, halo_r_enc])
    halo_valid = halo_enc > 0
    halo_gid = torch.where(halo_valid, halo_enc - 1, -1).to(gid.dtype)

    raw = torch.cat([halo_l_pts, halo_r_pts])
    inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    ghost_hi = torch.where(halo_valid[:, None], raw, -inf).amax(dim=0)
    ghost_lo = torch.where(halo_valid[:, None], raw, inf).amin(dim=0)
    hi_all = torch.maximum(pts.amax(dim=0), ghost_hi)
    lo_all = torch.minimum(pts.amin(dim=0), ghost_lo)
    span = (hi_all - lo_all).amax()
    fold = hi_all + 4.0 * eps + 1e-3 * span + 1e-6
    halo_pts = torch.where(halo_valid[:, None], raw, fold)

    ovf = axis.psum((lovf | rovf).to(torch.int32)) > 0
    return HaloExchange(halo_pts=halo_pts, halo_valid=halo_valid,
                        halo_gid=halo_gid, overflow=ovf,
                        lidx=lidx, lvalid=lvalid, ridx=ridx, rvalid=rvalid,
                        n_shards=n_shards)


def exchange_payload(ex: HaloExchange, values: torch.Tensor, fill,
                     axis: ShardAxis) -> torch.Tensor:
    """Ship per-point ``values`` of the fixed boundary sets along the same
    routes the points took; rows with no sender (slab edges, overflow
    padding) decode to ``fill``. Returns (2H,) aligned with
    ``ex.halo_pts``."""
    lv = torch.where(ex.lvalid, values[ex.lidx], fill)
    rv = torch.where(ex.rvalid, values[ex.ridx], fill)
    hl, hr = _xchg(axis, ex.n_shards, rv, lv)
    out = torch.cat([hl, hr])
    return torch.where(ex.halo_valid, out, fill)


def shard_context(pts: torch.Tensor, eps, halo_cap: int, axis: ShardAxis, *,
                  use_64bit: bool = True,
                  index_dtype=torch.int32) -> ShardContext:
    """Build the per-shard sharded-query substrate (call inside a mesh
    body): ε-ghost exchange, then trees over local ∪ ghost and local-only
    points. ``index_dtype`` sets the global-id dtype, int64 once
    ``n_shards * n_loc`` can exceed 2^31."""
    idx_dt = _canon_index_dtype(index_dtype)
    n_loc = pts.shape[0]
    gid = axis.index_tensor.to(idx_dt) * n_loc + torch.arange(
        n_loc, dtype=idx_dt, device=pts.device)
    ex = halo_exchange(pts, gid, eps, halo_cap, axis)

    all_pts = torch.cat([pts, ex.halo_pts]).contiguous()
    all_gid = torch.cat([gid, ex.halo_gid])
    bvh_all = build_bvh(all_pts, *scene_bounds(all_pts), use_64bit=use_64bit)
    bvh_local = build_bvh(pts, *scene_bounds(pts), use_64bit=use_64bit)
    sentinel = torch.tensor(axis.size * n_loc, dtype=idx_dt, device=pts.device)
    return ShardContext(gid=gid, exchange=ex, all_pts=all_pts,
                        all_gid=all_gid, bvh_all=bvh_all, bvh_local=bvh_local,
                        sentinel=sentinel)


def _local_order(ctx: ShardContext, n_loc: int) -> torch.Tensor:
    """The local points in the Morton order of ``bvh_all``'s leaves: the
    thread order of the local queries on that tree (it changes no
    result)."""
    perm = ctx.bvh_all.leaf_perm
    return perm[perm < n_loc].contiguous()


def sharded_query_csr(ctx: ShardContext, predicates, capacity: int, *,
                      chunk: int = 32, backend: str = "stackless",
                      order: torch.Tensor | None = None) -> DeviceCsr:
    """Cross-shard device CSR (call inside a mesh body): run the predicates
    against this shard's local ∪ ghost tree and remap hit indices to
    GLOBAL point ids (``ctx.gid``'s dtype). No host sync."""
    idx_dt = ctx.gid.dtype
    res = query_csr_device(ctx.bvh_all, predicates, capacity, chunk=chunk,
                           backend=backend, index_dtype=idx_dt, order=order)
    n_all = ctx.all_gid.shape[0]
    safe = res.indices.clamp(0, n_all - 1).long()
    gidx = torch.where(res.indices >= 0, ctx.all_gid[safe], -1).to(idx_dt)
    return DeviceCsr(offsets=res.offsets, indices=gidx, total=res.total,
                     overflowed=res.overflowed)


def sharded_neighbor_csr(points, eps, *, capacity: int, mesh: ShardMesh,
                         halo_cap: int = 512, chunk: int = 32,
                         backend: str = "stackless", use_64bit: bool = True,
                         index_dtype=torch.int32, tracer=None) -> ShardedCsr:
    """The reusable sharded-query layer, end to end: slab-sharded points
    in, per-shard ε-neighbour CSR out (GLOBAL point ids, self included),
    computed as per-shard tree build → ghost exchange → count-then-fill
    CSR on each shard of ``mesh``.

    ``points``: (n_total, d) pre-sorted by x (``slab_partition``), n_total
    divisible by the shard count. ``capacity`` bounds hits PER SHARD.
    ``index_dtype``: global-id/offset dtype, int64 once ``n_total`` or
    per-shard hits can exceed 2^31.

    ``tracer`` (a ``repro_torch.obs.SpanTracer``) wraps the run in one
    fenced span and samples the hit totals onto a counter track after the
    fence."""
    idx_dt = _canon_index_dtype(index_dtype)
    points = as_tensor_on(points, torch.float32, mesh.device)

    def local_fn(axis, pts):
        ctx = shard_context(pts, eps, halo_cap, axis, use_64bit=use_64bit,
                            index_dtype=idx_dt)
        res = sharded_query_csr(ctx, within(pts, eps), capacity, chunk=chunk,
                                backend=backend,
                                order=_local_order(ctx, pts.shape[0]))
        ovf = axis.psum(res.overflowed.to(torch.int32)) > 0
        return res.offsets, res.indices, res.total, ovf | ctx.exchange.overflow

    def run():
        offsets, indices, total, ovf = zip(*mesh.run(local_fn, points))
        return ShardedCsr(offsets=torch.stack(offsets),
                          indices=torch.stack(indices),
                          total=torch.stack(total),
                          overflowed=torch.stack(ovf).any())

    if tracer is None:
        return run()
    with tracer.span("sharded_neighbor_csr", n=int(points.shape[0]),
                     shards=mesh.n_shards, backend=backend) as sp:
        res = sp.fence(run())
    tracer.counter("csr_hits", total=int(res.total.sum()),
                   overflowed=int(res.overflowed))
    return res


def dbscan_local_shard(pts: torch.Tensor, eps, min_pts: int, ctx: ShardContext,
                       *, axis: ShardAxis, max_rounds: int = 64):
    """Per-shard DBSCAN body (call inside a mesh body):

      - core test: ε-counts over local ∪ ghost with early exit at min_pts;
      - local components: ``union_rounds`` fixpoint on the local tree;
      - global merge: exchange boundary labels, min-core-label traversal,
        hook onto local roots, repeat while a ``psum``'d flag says some
        shard changed a label, at most ``max_rounds`` rounds;
      - border points: a final min-core-label pass over local ∪ ghost.

    Returns (labels, core_mask, rounds, local_rounds) for the local
    points: labels are global point ids in ``ctx.gid``'s dtype, noise =
    -1; rounds is a () int32 tensor, the global merge's rounds;
    local_rounds, a Python int, the local fixpoint's (the host counted
    them, so reading them costs no sync)."""
    n_loc = pts.shape[0]
    ex = ctx.exchange
    sentinel = int(ctx.sentinel)
    idx_dt = ctx.gid.dtype
    order = _local_order(ctx, n_loc)
    with shared_pack(ctx.bvh_all), shared_pack(ctx.bvh_local):
        # --- core classification: ε-counts over local ∪ ghost --------------
        counts = count_neighbors(ctx.bvh_all, ctx.all_pts, pts, eps,
                                 min_pts=min_pts, order=order)
        core = counts >= min_pts
        halo_core = exchange_payload(ex, core.to(torch.int32), 0, axis) > 0
        all_core = torch.cat([core, halo_core])

        # --- local components: union fixpoint on the local tree -------------
        local_root, local_rounds = union_rounds(ctx.bvh_local, pts, eps, core,
                                                n_loc, max_rounds=max_rounds)
        lr = local_root.long()
        labels = torch.where(core, ctx.gid[lr], sentinel).to(idx_dt)

        def halo_labels(labels):
            return exchange_payload(ex, labels, sentinel, axis)

        # --- global merge rounds ----------------------------------------------
        changed, rounds = True, 0
        while changed and rounds < max_rounds:
            all_labels = torch.cat([labels, halo_labels(labels)])
            m = min_core_label_on(ctx.bvh_all, pts, eps, all_labels, all_core,
                                  core, sentinel, order=order)
            m = torch.where(core, torch.minimum(labels, m), sentinel)
            # scatter the min onto the LOCAL root, then broadcast back
            root_min = torch.full((n_loc,), sentinel, dtype=idx_dt,
                                  device=pts.device).scatter_reduce(
                0, lr, m, "amin", include_self=True)
            new = torch.where(core, root_min[lr], labels)
            changed_local = (new != labels).any().to(torch.int32)
            changed = bool(axis.psum(changed_local) > 0)
            labels, rounds = new, rounds + 1

        # --- border points ------------------------------------------------------
        all_labels = torch.cat([labels, halo_labels(labels)])
        border = min_core_label_on(ctx.bvh_all, pts, eps, all_labels, all_core,
                                   ~core, sentinel, order=order)
    final = torch.where(core, labels,
                        torch.where(border < sentinel, border, NOISE))
    final = torch.where(final == sentinel, NOISE, final)
    return (final.to(idx_dt), core,
            torch.tensor(rounds, dtype=torch.int32, device=pts.device),
            local_rounds)


def dbscan_distributed(points, eps, min_pts: int, *, mesh: ShardMesh,
                       halo_cap: int = 512, max_rounds: int = 64,
                       index_dtype=torch.int32, tracer=None) -> DistDbscanResult:
    """points: (n_total, d), n_total divisible by the shard count,
    pre-sorted by x (``slab_partition``) so shard slabs are contiguous;
    runs on ``mesh``'s device. ``index_dtype`` sets the global-label
    dtype, int64 once ``n_total`` can exceed 2^31.

    ``tracer`` (a ``repro_torch.obs.SpanTracer``) wraps the run in one
    fenced span and records the merge round count and halo overflow after
    the fence."""
    idx_dt = _canon_index_dtype(index_dtype)
    points = as_tensor_on(points, torch.float32, mesh.device)

    def local_fn(axis, pts):
        ctx = shard_context(pts, eps, halo_cap, axis, index_dtype=idx_dt)
        labels, core, rounds, _ = dbscan_local_shard(
            pts, eps, min_pts, ctx, axis=axis, max_rounds=max_rounds)
        return labels, core, rounds, ctx.exchange.overflow

    def run():
        labels, core, rounds, ovf = zip(*mesh.run(local_fn, points))
        return DistDbscanResult(labels=torch.cat(labels),
                                core_mask=torch.cat(core),
                                rounds=torch.stack(rounds).max(),
                                halo_overflow=torch.stack(ovf).any())

    if tracer is None:
        return run()
    with tracer.span("dbscan_distributed", n=int(points.shape[0]),
                     shards=mesh.n_shards, min_pts=int(min_pts)) as sp:
        res = sp.fence(run())
    tracer.counter("dbscan_rounds", rounds=int(res.rounds),
                   halo_overflow=int(res.halo_overflow))
    return res
