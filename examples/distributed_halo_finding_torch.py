"""Distributed halo finding on the PyTorch/CUDA port, the twin of
``examples/distributed_halo_finding.py``: HACC's MPI domain decomposition
as shard bodies and collectives on an in-process mesh of 8 shards of one
device (``ShardMesh``) — first stage by stage (DBSCAN, then the catalog),
then the whole thing again through ``halo_pipeline_sharded``: build →
ghost exchange → query → DBSCAN → catalog merge → SO masses in ONE body
per shard, with no host step between the stages but the fixpoint's
``changed`` flag.

Each stage is checked against the port's single-device path on the same
slab-sorted points: ``fdbscan``'s labels and core mask, ``halo_catalog``'s
catalog. ``tests/test_torch_distributed_example.py`` holds the run against
the reference's example and its numpy oracle.

  PYTHONPATH=src python examples/distributed_halo_finding_torch.py [--device cpu]

The default device is the CUDA card.
"""
import argparse
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ShardMesh, dbscan_distributed, fdbscan, slab_partition
from repro_torch.data.pipeline import hacc_benchmark_epsilon, make_clustered_points
from repro_torch.halos import (halo_catalog, halo_catalog_sharded,
                               halo_pipeline_sharded)

N = 1024
SHARDS = 8
HALO_CAP = 1024
CAPACITY = 128
MIN_COUNT = 10


class Distributed(NamedTuple):
    points: np.ndarray   # (N, 3) slab-sorted by x
    velocities: np.ndarray
    dbscan: object       # DistDbscanResult
    single: object       # fdbscan's DbscanResult on the same points
    catalog: object      # halo_catalog_sharded's HaloCatalog
    single_catalog: object
    pipeline: object     # HaloPipelineResult with SO masses


def make_points():
    """The reference example's particles (slab-sorted), velocities and eps."""
    pts = make_clustered_points(np.random.default_rng(1), N)
    pts_sorted, _ = slab_partition(pts, SHARDS)
    vel = np.random.default_rng(2).standard_normal((N, 3)).astype(np.float32)
    return pts_sorted, vel, hacc_benchmark_epsilon(1.0, N)


def run(device=None) -> Distributed:
    """Every stage of the example on 8 shards of ``device`` (``None``: the
    CUDA card), and the single-device results it is checked against."""
    pts, vel, eps = make_points()
    mesh = ShardMesh(SHARDS, device)
    res = dbscan_distributed(pts, eps, 2, mesh=mesh, halo_cap=HALO_CAP)
    single = fdbscan(pts, eps, 2, device=mesh.device)
    cat = halo_catalog_sharded(pts, vel, res.labels, mesh=mesh,
                               capacity=CAPACITY, min_count=MIN_COUNT)
    single_cat = halo_catalog(pts, vel, res.labels, capacity=CAPACITY,
                              min_count=MIN_COUNT, device=mesh.device)
    pipe = halo_pipeline_sharded(pts, vel, eps, 2, mesh=mesh,
                                 capacity=CAPACITY, halo_cap=HALO_CAP,
                                 min_count=MIN_COUNT, so_delta=200.0)
    return Distributed(pts, vel, res, single, cat, single_cat, pipe)


def report(out: Distributed) -> None:
    """Print the example's report of ``out`` and check each stage against
    the single-device path."""
    res = out.dbscan
    print(f"distributed FOF over {SHARDS} shards: rounds={int(res.rounds)} "
          f"halo_overflow={bool(res.halo_overflow)}")
    labels = res.labels.cpu().numpy()
    print(f"{int((labels >= 0).sum())} clustered / {N}, "
          f"{len(np.unique(labels[labels >= 0]))} clusters")
    assert not bool(res.halo_overflow)
    assert torch.equal(res.labels, out.single.labels)
    assert torch.equal(res.core_mask, out.single.core_mask)
    print("matches the single-device fdbscan.")

    cat, single = out.catalog, out.single_catalog
    nh = int(cat.num_halos)
    assert nh == int(single.num_halos)
    for f in ("root", "count", "particle_halo"):
        assert torch.equal(getattr(cat, f), getattr(single, f)), f
    torch.testing.assert_close(cat.center, single.center, rtol=0, atol=1e-5)
    count = cat.count.cpu().numpy()
    top = np.argsort(-count[:nh], kind="stable")[:5]
    print(f"merged catalog across {SHARDS} shards: {nh} halos "
          f"(>={MIN_COUNT} particles); top 5:")
    for h in top:
        print(f"  root={int(cat.root[h]):4d} count={int(cat.count[h]):4d} "
              f"center={np.round(cat.center[h].cpu().numpy(), 3)} "
              f"vdisp={float(cat.vdisp[h]):.3f} rmax={float(cat.rmax[h]):.4f}")
    print("sharded catalog == single-device catalog.")

    pipe = out.pipeline
    assert torch.equal(pipe.labels, res.labels)
    assert int(pipe.catalog.num_halos) == nh
    torch.testing.assert_close(pipe.catalog.center, cat.center, rtol=0,
                               atol=1e-5)
    nb = int(pipe.so.bracketed.sum())
    print(f"fused pipeline: rounds={int(pipe.rounds)}, {nh} halos, "
          f"SO masses bracketed for {nb}; one body per shard end to end.")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    report(run(args.device))


if __name__ == "__main__":
    main()
