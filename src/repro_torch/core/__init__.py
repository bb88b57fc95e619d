"""Spatial core of the port (``repro/core/__init__.py``): geometry, Morton
codes, the LBVH, the cell grid, the query engine and its protocols (the
pair backend included), the traversal shims, union-find, the DBSCAN
variants, the pair correlation, and the sharded layer (``distributed.py``
on the in-process mesh of ``mesh.py``), and the nearest family: ``knn``,
``emst``, ``interpolate`` and ``raycast``. Re-exports the reference's
list and the port's own additions."""
from repro_torch.core.bvh import SENTINEL, Bvh, build_bvh, build_bvh_objects
from repro_torch.core.cell_grid import CellGrid, build_cell_grid, cell_box
from repro_torch.core.correlation import pair_count_histogram, two_point_correlation
from repro_torch.core.dbscan import (
    NOISE,
    DbscanResult,
    count_neighbors,
    dbscan_graph_cc,
    fdbscan,
    fdbscan_densebox,
    fdbscan_pair,
    min_core_label_on,
    seg_min_per_point,
    union_rounds,
)
from repro_torch.core.distributed import (
    DistDbscanResult,
    HaloExchange,
    ShardContext,
    ShardedCsr,
    dbscan_distributed,
    dbscan_local_shard,
    exchange_payload,
    halo_exchange,
    shard_context,
    sharded_neighbor_csr,
    sharded_query_csr,
    slab_partition,
)
from repro_torch.core.geometry import Aabb, aabb_of_points
from repro_torch.core.mesh import ShardAxis, ShardMesh
from repro_torch.core.morton import morton32, morton64, normalize_points
from repro_torch.core.query import (
    BufferedCsr,
    DeviceCsr,
    IntersectsBox,
    Nearest,
    NearestResult,
    Ray,
    RayResult,
    Within,
    intersects_box,
    nearest,
    node_reduce,
    query,
    query_count,
    query_csr,
    query_csr_buffered,
    query_csr_device,
    query_fixed,
    ray,
    within,
)
from repro_torch.core.traversal import (
    pair_traverse_sphere,
    traverse_sphere_stack,
    traverse_sphere_stackless,
)
from repro_torch.core.knn import KnnResult, knn
from repro_torch.core.emst import EmstResult, emst
from repro_torch.core.interpolate import mls_interpolate
from repro_torch.core.raycast import RayHits, raycast, raycast_all
from repro_torch.core import union_find

__all__ = [
    "Bvh", "build_bvh", "build_bvh_objects", "SENTINEL",
    "NOISE", "DbscanResult", "count_neighbors",
    "min_core_label_on", "union_rounds",
    "dbscan_graph_cc", "fdbscan", "fdbscan_pair", "fdbscan_densebox",
    "seg_min_per_point",
    "CellGrid", "build_cell_grid", "cell_box",
    "pair_count_histogram", "two_point_correlation",
    "Aabb", "aabb_of_points",
    "morton32", "morton64", "normalize_points",
    "Within", "IntersectsBox", "Nearest", "Ray",
    "NearestResult", "RayResult", "DeviceCsr", "BufferedCsr",
    "within", "intersects_box", "nearest", "ray",
    "query", "query_count", "query_csr", "query_csr_buffered",
    "query_csr_device", "query_fixed",
    "node_reduce",
    "pair_traverse_sphere", "traverse_sphere_stack", "traverse_sphere_stackless",
    "KnnResult", "knn", "EmstResult", "emst",
    "mls_interpolate", "RayHits", "raycast", "raycast_all",
    "union_find",
    "ShardMesh", "ShardAxis",
    "DistDbscanResult", "HaloExchange", "ShardContext", "ShardedCsr",
    "slab_partition", "halo_exchange", "exchange_payload", "shard_context",
    "sharded_query_csr", "sharded_neighbor_csr", "dbscan_local_shard",
    "dbscan_distributed",
]
