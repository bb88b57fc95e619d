"""Spatial core of the port (``repro/core/__init__.py``): geometry, Morton
codes, the LBVH, the query engine and its protocols, the traversal shims,
union-find and DBSCAN. Re-exports the ported names of the reference's
list; ``cell_grid``, ``knn``, ``emst``, ``correlation``, ``interpolate``,
``raycast``, ``fdbscan_pair`` and ``fdbscan_densebox`` are not ported yet
(ROADMAP A9, A10)."""
from repro_torch.core.bvh import SENTINEL, Bvh, build_bvh, build_bvh_objects
from repro_torch.core.dbscan import (
    NOISE,
    DbscanResult,
    count_neighbors,
    dbscan_graph_cc,
    fdbscan,
    min_core_label_on,
    union_rounds,
)
from repro_torch.core.geometry import Aabb, aabb_of_points
from repro_torch.core.morton import morton32, morton64, normalize_points
from repro_torch.core.query import (
    BufferedCsr,
    DeviceCsr,
    IntersectsBox,
    Nearest,
    Ray,
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
from repro_torch.core import union_find

__all__ = [
    "Bvh", "build_bvh", "build_bvh_objects", "SENTINEL",
    "NOISE", "DbscanResult", "count_neighbors",
    "min_core_label_on", "union_rounds",
    "dbscan_graph_cc", "fdbscan",
    "Aabb", "aabb_of_points",
    "morton32", "morton64", "normalize_points",
    "Within", "IntersectsBox", "Nearest", "Ray",
    "DeviceCsr", "BufferedCsr",
    "within", "intersects_box", "nearest", "ray",
    "query", "query_count", "query_csr", "query_csr_buffered",
    "query_csr_device", "query_fixed",
    "node_reduce",
    "pair_traverse_sphere", "traverse_sphere_stack", "traverse_sphere_stackless",
    "union_find",
]
