"""Distributed halo-catalog reduction: merge per-shard partials by root;
port of ``repro/halos/merge.py``.

``core/distributed.py`` ends with GLOBAL labels (cluster root = min global
particle id) spread over the shards. Halos straddle slab boundaries, so no
shard can finalize a catalog alone. The HACC pattern: each rank reduces
its LOCAL particles into per-root partial sums, the partial catalogs are
merged by root label across ranks, and the radius takes one more local
pass.

A partial-catalog row ``[count, Σx, Σv, Σ|v|²]`` is a weighted
pseudo-particle in the feature layout of the single-device reduction, so
the cross-shard merge is ``catalog.feature_sums``'s segmented reduction
applied one level up: the canonicalized rows are sorted by provisional
halo id, and ``segment_sum_sorted`` (the segment kernel on the card, which
gives the same bits on every call) sums them.

Protocol (``halo_catalog_sharded``, one body per shard of a ``ShardMesh``):

1. every shard: ``partial_catalog`` over its local particles;
2. ``all_gather`` of the fixed-capacity partial tables (S × H rows);
3. every shard runs the same ``merge_partial_catalogs``, so every shard
   holds the same full catalog;
4. the max radius: each shard scatter-maxes its particles' |x − center|²
   against the merged centers (root → slot by ``searchsorted`` on the
   catalog's ascending-root prefix), combined with ``pmax``.

The functions of (1), (3) and (4) also run without a mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distributed import (dbscan_distributed,
                                          dbscan_local_shard, shard_context)
from repro_torch.core.mesh import ShardAxis, ShardMesh
from repro_torch.core.query import _canon_index_dtype
from repro_torch.device import as_tensor_on
from repro_torch.halos.catalog import (NOISE, HaloCatalog, _sort_last, _sum3,
                                       canonicalize_labels, derive_catalog,
                                       feature_sums, label_dtype)
from repro_torch.halos.so_mass import (SoMassResult, so_masses,
                                       so_masses_from_counts, sphere_counts)
from repro_torch.kernels.segment import SEG_NEG_BIG, segment_sum_sorted
from repro_torch.kernels.wavefront import shared_pack
from repro_torch.obs.trace import traced

__all__ = [
    "PartialCatalog",
    "HaloPipelineResult",
    "partial_catalog",
    "merge_partial_catalogs",
    "local_rmax2",
    "particle_slots",
    "finalize_rmax",
    "halo_catalog_sharded",
    "halo_pipeline_sharded",
    "halo_pipeline_traced",
]


class PartialCatalog(NamedTuple):
    """Per-shard halo sums keyed by GLOBAL root label (-1 = empty row)."""

    root: torch.Tensor      # (H,) label dtype (int64 global ids at scale)
    sums: torch.Tensor      # (H, 2d+2) f32, [count, Σx, Σv, Σ|v|²]
    overflow: torch.Tensor  # () bool


def partial_catalog(points: torch.Tensor, velocities: torch.Tensor,
                    labels: torch.Tensor, *, capacity: int) -> PartialCatalog:
    """One shard's raw per-root sums (linear in particles, so mergeable)."""
    sums, root, overflow, _, _, _ = feature_sums(points, velocities, labels,
                                                 capacity=capacity)
    return PartialCatalog(root=root, sums=sums, overflow=overflow)


def merge_partial_catalogs(roots: torch.Tensor, sums: torch.Tensor, *,
                           capacity: int, min_count=2, particle_mass=1.0,
                           n_particles: int = 0) -> HaloCatalog:
    """Concatenated partial rows (S·H,) / (S·H, 2d+2) -> merged catalog.

    Rows are pseudo-particles: canonicalize roots, segment-sum the stored
    sums, derive. ``rmax`` comes back zeroed (it needs particle data: run
    ``local_rmax2`` and ``finalize_rmax``). ``particle_halo`` is
    (n_particles,) of -1 (per-shard maps come from ``particle_slots``)."""
    d = (sums.shape[1] - 2) // 2
    dev = sums.device
    # Empty partial rows (root -1 or zero count) become noise, then the rows
    # canonicalize exactly like particles do.
    roots_eff = torch.where((roots >= 0) & (sums[:, 0] > 0), roots, NOISE)
    perm, pid_s, root_s, member_s, _nprov, overflow = \
        canonicalize_labels(roots_eff, capacity)

    rows = torch.where(member_s[:, None], sums[perm.long()], 0.0)
    merged = segment_sum_sorted(rows.contiguous(), pid_s, capacity)
    sl = _sort_last(root_s.dtype)
    root_m = torch.full((capacity,), sl, dtype=root_s.dtype,
                        device=dev).scatter_reduce(
        0, pid_s.long(), torch.where(member_s, root_s, sl), "amin",
        include_self=True)
    root_m = torch.where(root_m == sl, NOISE, root_m)

    (num_halos, root, count, mass, center, vmean, vdisp, _slot) = \
        derive_catalog(merged, root_m, min_count, particle_mass, d)
    return HaloCatalog(
        num_halos=num_halos, overflow=overflow, root=root, count=count,
        mass=mass, center=center, vmean=vmean, vdisp=vdisp,
        rmax=torch.zeros(capacity, dtype=torch.float32, device=dev),
        particle_halo=torch.full((max(n_particles, 1),), -1,
                                 dtype=torch.int32, device=dev))


def particle_slots(labels: torch.Tensor, cat: HaloCatalog) -> torch.Tensor:
    """Root label per particle -> catalog slot (int32, -1 if noise or
    cut), by ``searchsorted`` on the catalog's ascending-root valid
    prefix."""
    capacity = cat.root.shape[0]
    key = torch.where(cat.count > 0, cat.root, _sort_last(cat.root.dtype))
    lab = labels.to(key.dtype)
    pos = torch.searchsorted(key, lab.clamp(min=0)).to(torch.int32)
    pos_c = pos.clamp(0, capacity - 1)
    found = (lab >= 0) & (pos < capacity) & (key[pos_c.long()] == lab)
    return torch.where(found, pos_c, -1)


def local_rmax2(points: torch.Tensor, labels: torch.Tensor,
                cat: HaloCatalog) -> torch.Tensor:
    """One shard's contribution to per-halo max |x − center|²
    (``-SEG_NEG_BIG`` where the shard holds no members)."""
    capacity = cat.root.shape[0]
    slot = particle_slots(labels, cat)
    slot_c = slot.clamp(0, capacity - 1).long()
    diff = points.to(torch.float32) - cat.center[slot_c]
    r2 = torch.where(slot >= 0, _sum3(diff * diff), -SEG_NEG_BIG)
    return torch.full((capacity,), -SEG_NEG_BIG, dtype=torch.float32,
                      device=points.device).scatter_reduce(
        0, slot_c, r2, "amax", include_self=True)


def finalize_rmax(cat: HaloCatalog, rmax2: torch.Tensor) -> HaloCatalog:
    """Install the (already cross-shard-combined) max radius²."""
    rmax = torch.sqrt(torch.clamp(rmax2, min=0.0))
    return cat._replace(rmax=torch.where(cat.count > 0, rmax, 0.0))


def _catalog_shard(axis: ShardAxis, pts, vel, lab, *, capacity: int,
                   min_count, particle_mass) -> HaloCatalog:
    """Steps 1-4 in one shard's body: the merged catalog, the same on
    every shard, with this shard's particle slots as ``particle_halo``."""
    part = partial_catalog(pts, vel, lab, capacity=capacity)
    roots_all = axis.all_gather(part.root)                   # (S, H)
    sums_all = axis.all_gather(part.sums)                    # (S, H, F)
    cat = merge_partial_catalogs(
        roots_all.reshape(-1), sums_all.reshape(-1, sums_all.shape[-1]),
        capacity=capacity, min_count=min_count, particle_mass=particle_mass)
    cat = finalize_rmax(cat, axis.pmax(local_rmax2(pts, lab, cat)))
    ovf = axis.psum(part.overflow.to(torch.int32)) > 0
    return cat._replace(overflow=cat.overflow | ovf,
                        particle_halo=particle_slots(lab, cat))


def _gather_slots(cats: list[HaloCatalog]) -> HaloCatalog:
    """Shard 0's catalog (every shard holds the same one) with the
    particle slots of all shards in shard order."""
    return cats[0]._replace(
        particle_halo=torch.cat([c.particle_halo for c in cats]))


def halo_catalog_sharded(points, velocities, labels, *, mesh: ShardMesh,
                         capacity: int, min_count=2,
                         particle_mass=1.0) -> HaloCatalog:
    """Sharded labels → catalog, composing with ``dbscan_distributed``.

    Inputs are (n_total, …) in ``dbscan_distributed``'s layout (slabs in
    shard order; labels its global root ids, int32 or int64), on
    ``mesh``'s device. Returns the catalog every shard computed, with
    ``particle_halo`` (n_total,) in the particles' order."""
    dev = mesh.device
    points = as_tensor_on(points, torch.float32, dev)
    velocities = as_tensor_on(velocities, torch.float32, dev)
    labels = as_tensor_on(labels, label_dtype(labels), dev)

    def local_fn(axis, pts, vel, lab):
        return _catalog_shard(axis, pts, vel, lab, capacity=capacity,
                              min_count=min_count, particle_mass=particle_mass)

    return _gather_slots(mesh.run(local_fn, points, velocities, labels))


class HaloPipelineResult(NamedTuple):
    """Everything the one-body pipeline produces."""
    labels: torch.Tensor         # (n_total,) global DBSCAN labels
    core_mask: torch.Tensor      # (n_total,) bool
    rounds: torch.Tensor         # () int32 global merge rounds
    halo_overflow: torch.Tensor  # () bool, ghost buffer overflow anywhere
    catalog: HaloCatalog         # the merged catalog (particle_halo per particle)
    so: SoMassResult | None      # with so_delta, else None


def halo_pipeline_sharded(points, velocities, eps, min_pts: int, *,
                          mesh: ShardMesh, capacity: int, halo_cap: int = 512,
                          min_count: int = 2, particle_mass: float = 1.0,
                          max_rounds: int = 64, so_delta: float | None = None,
                          box_volume: float = 1.0, so_r_max: float = 0.25,
                          so_iters: int = 20, index_dtype=torch.int32,
                          tracer=None) -> HaloPipelineResult:
    """The paper's exascale pipeline in ONE body per shard: tree builds →
    ε-ghost exchange → distributed DBSCAN → catalog merge → max-radius
    pass → (with ``so_delta``) SO masses, with no host step between the
    stages but the fixpoint's ``changed`` flag.

    Inputs are (n_total, d) slab-partitioned like ``dbscan_distributed``'s
    (pre-sorted by x, n_total divisible by the shard count). The SO counts
    run against each shard's LOCAL tree and are ``psum``'d: the centers
    are the same on every shard, so every shard probes the same spheres
    over its own particles and the sum is the global count.

    ``tracer`` wraps the run in ONE fenced span; for a per-stage trace use
    :func:`halo_pipeline_traced`, which gives the same result."""
    idx_dt = _canon_index_dtype(index_dtype)
    dev = mesh.device
    points = as_tensor_on(points, torch.float32, dev)
    velocities = as_tensor_on(velocities, torch.float32, dev)
    n_total = points.shape[0]

    def local_fn(axis, pts, vel):
        ctx = shard_context(pts, eps, halo_cap, axis, index_dtype=idx_dt)
        labels, core, rounds = dbscan_local_shard(
            pts, eps, min_pts, ctx, axis=axis, max_rounds=max_rounds)
        cat = _catalog_shard(axis, pts, vel, labels, capacity=capacity,
                             min_count=min_count, particle_mass=particle_mass)
        so = None
        if so_delta is not None:
            def count_fn(c, r):
                return axis.psum(sphere_counts(ctx.bvh_local, pts, c, r))

            with shared_pack(ctx.bvh_local):
                so = so_masses_from_counts(
                    count_fn, cat.center, cat.count > 0, delta=so_delta,
                    particle_mass=particle_mass, n_particles=n_total,
                    box_volume=box_volume, r_max=so_r_max, iters=so_iters)
        return labels, core, rounds, ctx.exchange.overflow, cat, so

    def run():
        labels, core, rounds, ovf, cats, so = zip(
            *mesh.run(local_fn, points, velocities))
        return HaloPipelineResult(
            labels=torch.cat(labels), core_mask=torch.cat(core),
            rounds=torch.stack(rounds).max(),
            halo_overflow=torch.stack(ovf).any(),
            catalog=_gather_slots(list(cats)), so=so[0])

    if tracer is None:
        return run()
    with tracer.span("halo_pipeline_sharded", n=int(n_total),
                     shards=mesh.n_shards, fused=True) as sp:
        res = sp.fence(run())
    tracer.counter("halo_pipeline", rounds=int(res.rounds),
                   num_halos=int(res.catalog.num_halos),
                   halo_overflow=int(res.halo_overflow))
    return res


def halo_pipeline_traced(points, velocities, eps, min_pts: int, *,
                         mesh: ShardMesh, capacity: int, halo_cap: int = 512,
                         min_count: int = 2, particle_mass: float = 1.0,
                         max_rounds: int = 64, so_delta: float | None = None,
                         box_volume: float = 1.0, so_r_max: float = 0.25,
                         so_iters: int = 20, index_dtype=torch.int32,
                         tracer=None) -> HaloPipelineResult:
    """The STAGED pipeline: ``dbscan_distributed`` → ``halo_catalog_sharded``
    → ``so_masses`` (one tree over all the particles) as separate runs,
    each in its own fenced span, so a Perfetto trace shows where the time
    goes. It gives :func:`halo_pipeline_sharded`'s result, at the cost of
    host fences between the stages."""
    dev = mesh.device
    points = as_tensor_on(points, torch.float32, dev)
    velocities = as_tensor_on(velocities, torch.float32, dev)

    def run():
        dd = dbscan_distributed(points, eps, min_pts, mesh=mesh,
                                halo_cap=halo_cap, max_rounds=max_rounds,
                                index_dtype=index_dtype, tracer=tracer)
        cat = traced(tracer, "halo_catalog_sharded", halo_catalog_sharded,
                     points, velocities, dd.labels, mesh=mesh,
                     capacity=int(capacity), min_count=min_count,
                     particle_mass=particle_mass)
        so = None
        if so_delta is not None:
            so = traced(tracer, "so_masses", so_masses, points, cat.center,
                        cat.count > 0, delta=so_delta,
                        particle_mass=particle_mass, box_volume=box_volume,
                        r_max=so_r_max, iters=so_iters, device=dev)
        return HaloPipelineResult(
            labels=dd.labels, core_mask=dd.core_mask, rounds=dd.rounds,
            halo_overflow=dd.halo_overflow, catalog=cat, so=so)

    if tracer is None:
        return run()
    with tracer.span("halo_pipeline_traced", n=int(points.shape[0]),
                     shards=mesh.n_shards, fused=False):
        return run()
