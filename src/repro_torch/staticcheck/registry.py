"""Registered op audits: the port's device pipelines, each run under an
:class:`~repro_torch.staticcheck.op_audit.OpTrace` and checked against the
Layer-1 rules; port of ``repro/staticcheck/registry.py``, one entry for
each of the reference's nine, under the same names.

The registry is consumed three ways:

* ``pytest`` — ``tests/test_torch_staticcheck.py`` parametrizes one test
  per audit on the CPU, so a regression names the entry point that broke;
* the CLI — ``python -m repro_torch.staticcheck --ops [--fast] [--device
  cpu|cuda]`` runs them all and folds the findings into the JSON report;
* ``chip_smoke.py`` phase 19 runs them on the card and holds each audited
  call's sync count against the card's own sync warnings
  (:attr:`Audit.calls`).

Budgets are sized per entry point as "the dense object this pipeline must
NOT stage": ``q x max_count`` for CSR fills, ``n x n`` for neighbor
pipelines. Sync allowances count the passes of the code's host loops
(each helper below names its lines), in the problem size, the height of
the tree a build on the same input makes and the rounds a call returns;
none is copied from a measured count. Pointer jumping's passes are the
one bound (:func:`compress_syncs`). The device CSR and the wavefront
backend are allowed none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.op_audit import (audit_ops, bounded_recompiles,
                                              no_dense_intermediate,
                                              no_host_transfer, op_signature)

__all__ = ["Audit", "Call", "REGISTERED_AUDITS", "run_registered_audits",
           "tree_height", "height_of", "search_syncs", "build_bvh_syncs",
           "compress_syncs", "fdbscan_syncs", "fdbscan_pair_syncs",
           "halo_pipeline_syncs"]


class Call(NamedTuple):
    """One audited call. ``budget`` and ``allowed_syncs`` feed
    ``no_dense_intermediate`` and ``no_host_transfer``; None leaves the
    rule out (the call is then only probed by phase 19's sync check)."""
    name: str
    fn: Callable
    args: tuple
    budget: int | None
    allowed_syncs: int | Callable | None


@dataclasses.dataclass(frozen=True)
class Audit:
    name: str
    calls: Callable | None = None   # (fast, device) -> list[Call]
    check: Callable | None = None   # (fast, device) -> list[Finding]

    def run(self, fast: bool = True, device=None) -> list[Finding]:
        """The entry's findings at the fast or full size on ``device``
        (``None``: the CUDA card)."""
        dev = resolve_device(device)
        findings: list[Finding] = []
        for c in (self.calls(fast, dev) if self.calls else ()):
            rules = []
            if c.budget is not None:
                rules.append(no_dense_intermediate(c.budget))
            if c.allowed_syncs is not None:
                rules.append(no_host_transfer(c.allowed_syncs))
            findings.extend(audit_ops(c.fn, c.args, rules, name=c.name))
        if self.check:
            findings.extend(self.check(fast, dev))
        return findings


# --- sync allowances, from the code's loops ---------------------------------
#
# Each helper counts the passes of the loops it names. Where a loop's trip
# count is known, the helper takes it: a tree's height (``tree_height`` of
# a build on the same input), the rounds a call returns. Pointer jumping
# (``compress_syncs``) is the one bound: its passes depend on the forest's
# longest path, which no call returns, so it counts the most n allows.

def tree_height(bvh) -> int:
    """The deepest node's depth in ``bvh`` (``core/bvh.py`` ``node_depths``):
    the passes of ``build_bvh``'s box fixpoint (:160-168), which finishes
    the nodes of one height a pass, and of ``node_depths``' loop
    (:189-193), which descends one level a pass."""
    from repro_torch.core.bvh import node_depths

    return int(node_depths(bvh).max())


def height_of(points) -> int:
    """:func:`tree_height` of the tree ``build_bvh`` makes over ``points``
    in their scene bounds, as ``fdbscan``, ``fdbscan_pair`` and
    ``shard_context`` build it."""
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds

    return tree_height(build_bvh(points, *scene_bounds(points)))


def search_syncs(n: int) -> int:
    """``build_bvh``'s three searches (``core/bvh.py:73-91``), decided by
    the root, whose range of n - 1 is the widest: the exponential search
    doubles ``l_max`` from 2 past it, a boolean index a pass
    (``bit_length(n - 1)`` passes); the binary search halves ``t`` from
    ``l_max / 2`` and reads its condition a pass and once more at 0; the
    split search halves ``t`` from n - 1 rounding up, then reads 0."""
    b = (int(n) - 1).bit_length()
    return b + (b + 1) + ((int(n) - 2).bit_length() + 2)


def build_bvh_syncs(n: int, height: int) -> int:
    """``build_bvh`` over n points into a tree of ``height``: the searches,
    and the box fixpoint's four boolean indexes and one indexed assignment
    of a Python ``True`` (on the card a copy from the host) a pass."""
    return search_syncs(n) + 5 * height


def compress_syncs(n: int) -> int:
    """``union_find.compress`` (``core/union_find.py:15-21``): one
    ``bool`` a pointer-jumping pass; a path of at most n - 1 links halves
    each pass, and the last pass finds no change. A bound: the passes
    the data needs are fewer where the forest is shallow."""
    return max(int(n) - 1, 1).bit_length() + 1


def fdbscan_syncs(n: int, height: int, rounds: int) -> int:
    """``fdbscan`` (``core/dbscan.py:135-162``): the build; the count
    pass's ``within`` constant (a scalar from the host); per union round
    (:123-131) its ``within`` constant, the hook's compress and the
    ``changed`` read; the border pass's constant; the final compress of
    ``_finish_labels``; the ``num_rounds`` tensor."""
    return (build_bvh_syncs(n, height) + 3 + compress_syncs(n)
            + rounds * (2 + compress_syncs(n)))


def fdbscan_pair_syncs(n: int, height: int, rounds: int) -> int:
    """``fdbscan_pair`` (``core/dbscan.py:208-256``): the build; the
    predicate's and the count pass's ``within`` constants; per round
    (:236-248) the ``overflow`` read, two boolean indexes of the buffer,
    the compress and the ``changed`` read; the border pass's constant;
    ``_finish_labels``'s compress; the ``num_rounds`` tensor."""
    return (build_bvh_syncs(n, height) + 4 + compress_syncs(n)
            + rounds * (4 + compress_syncs(n)))


def halo_pipeline_syncs(n_loc: int, halo_cap: int, heights, local_rounds,
                        rounds: int) -> int:
    """``halo_pipeline_sharded`` (``halos/merge.py:229-248``) with SO
    masses, summed over the shards: ``shard_context``
    (``core/distributed.py:206-226``: three host constants, the builds
    over local ∪ ghost and local points, ``heights[k]`` their heights);
    ``dbscan_local_shard`` (:299-362: the ``sentinel`` read,
    ``_local_order``'s boolean index, the count pass's constant, the local
    ``union_rounds`` fixpoint's ``local_rounds[k]`` rounds of a constant,
    a compress and a ``changed`` read, each of the ``rounds`` merge
    rounds' constant and ``changed`` read (the psum'd flag gives every
    shard the same count), the border pass's constant, the rounds
    tensor); the catalog's particle-mass constant
    (``halos/catalog.py:141``); the SO bisection's five constants
    (``halos/so_mass.py:52``)."""
    n_all = n_loc + 2 * halo_cap
    return sum(3 + build_bvh_syncs(n_all, h_all) + build_bvh_syncs(n_loc, h_loc)
               + 5 + r_loc * (2 + compress_syncs(n_loc)) + 2 * rounds + 1 + 5
               for (h_all, h_loc), r_loc in zip(heights, local_rounds))


# --- workloads ----------------------------------------------------------------

def _skewed_workload(n: int, nq: int, dev):
    """One fat query matching every point, the rest matching none: the
    workload where a dense ``(q, max_count)`` fill buffer is maximal."""
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.core.query import within

    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
    bvh = build_bvh(pts, *scene_bounds(pts))
    queries = np.full((nq, 3), 50.0, np.float32)
    queries[0] = 0.5
    radii = np.full((nq,), 1e-3, np.float32)
    radii[0] = 2.0
    pred = within(torch.from_numpy(queries).to(dev),
                  torch.from_numpy(radii).to(dev))
    return bvh, pred


def _clustered(n: int, dev):
    from repro_torch.data.pipeline import (hacc_benchmark_epsilon,
                                           make_clustered_points)

    pts = make_clustered_points(np.random.default_rng(0), n)
    return torch.from_numpy(pts).to(dev), float(hacc_benchmark_epsilon(1.0, n))


def _rounds_of(result) -> int:
    return int(result.num_rounds)


def _csr_device_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.core.query import query_csr_device

    n = nq = 128 if fast else 256
    bvh, pred = _skewed_workload(n, nq, dev)
    dense = nq * n  # the forbidden (q, max_count) buffer
    return [Call("query_csr_device",
                 lambda b, p: query_csr_device(b, p, capacity=n + 64, chunk=16),
                 (bvh, pred), dense, 0)]


def _fdbscan_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.core.dbscan import fdbscan

    n = 128 if fast else 512
    pts, eps = _clustered(n, dev)
    h = height_of(pts)
    return [Call("fdbscan", lambda p: fdbscan(p, eps, 2, device=p.device),
                 (pts,), n * n, lambda r: fdbscan_syncs(n, h, _rounds_of(r)))]


def _fdbscan_pair_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.core.dbscan import fdbscan_pair

    n = 128 if fast else 512
    pts, eps = _clustered(n, dev)
    h = height_of(pts)
    return [Call("fdbscan_pair",
                 lambda p: fdbscan_pair(p, eps, 2, device=p.device), (pts,),
                 n * n, lambda r: fdbscan_pair_syncs(n, h, _rounds_of(r)))]


SHARDS = 4
HALO_CAP = 64
HALO_EPS = 0.05


def _halo_pipeline_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.core.distributed import shard_context
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.halos import halo_pipeline_sharded

    n = 128 if fast else 256
    mesh = ShardMesh(SHARDS, dev)
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(np.sort(
        rng.uniform(0, 1, (n, 3)).astype(np.float32), axis=0)).to(dev)
    vel = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)

    def shard_heights(axis, p):   # the trees shard_context builds
        ctx = shard_context(p, HALO_EPS, HALO_CAP, axis)
        return tree_height(ctx.bvh_all), tree_height(ctx.bvh_local)

    heights = mesh.run(shard_heights, pts)
    return [Call(
        "halo_pipeline_sharded",
        lambda p, v: halo_pipeline_sharded(
            p, v, HALO_EPS, 2, mesh=mesh, capacity=64, halo_cap=HALO_CAP,
            min_count=2, so_delta=200.0),
        (pts, vel), n * n,
        lambda r: halo_pipeline_syncs(n // SHARDS, HALO_CAP, heights,
                                      r.local_rounds, int(r.rounds)))]


# On the CPU the all-pairs op runs its plain version, which tiles the
# (m, n) matrix into blocks of ``kernels/pairwise.py``'s _PLAIN_TILE
# (2^24) elements: only m·n above that shows the tiling. 4608^2 is 1.27
# tiles, two blocks of rows.
PAIRWISE_ROWS = 4608


def _pairwise_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.kernels import ops

    m = n = PAIRWISE_ROWS
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    # budget: the full (m, n) pairwise mask; the op must stay tiled
    return [Call("eps_neighbor_counts",
                 lambda a: ops.eps_neighbor_counts(a, a, 0.1), (x,), m * n, 0)]


def _serving_setup(fast: bool, dev):
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.core.query import query_count, within

    n = 64
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
    bvh = build_bvh(pts, *scene_bounds(pts))

    def bucketed(nq: int):
        cap = 1 << max(2, (nq - 1).bit_length())   # next power of two, >= 4
        q = np.full((cap, 3), 50.0, np.float32)    # pad with far-away queries
        q[:nq] = rng.uniform(0, 1, (nq, 3)).astype(np.float32)
        return (torch.from_numpy(q).to(dev),)

    sizes = [1, 2, 3, 4, 5, 7, 8] if fast else list(range(1, 33))
    sweep = [bucketed(nq) for nq in sizes]
    cap = 3 if fast else 5  # buckets {4, 8} fast; {4, 8, 16, 32} full
    return (lambda q: query_count(bvh, within(q, 0.1))), sweep, cap


def _serving_calls(fast: bool, dev) -> list[Call]:
    fn, sweep, _ = _serving_setup(fast, dev)
    return [Call("serving_bucketed_query", fn, sweep[-1], None, None)]


def _serving_check(fast: bool, dev) -> list[Finding]:
    """The serving tier's fixed-bucket premise: a sweep of arbitrary
    request sizes, padded to power-of-two buckets, must hit a bounded
    number of shapes."""
    fn, sweep, cap = _serving_setup(fast, dev)
    return bounded_recompiles(fn, sweep, cap, name="serving_bucketed_query")


def _identity_setup(fast: bool, dev):
    n, nq = (32, 8) if fast else (256, 64)
    return _skewed_workload(n, nq, dev)


def _identity_calls(fast: bool, dev) -> list[Call]:
    from repro_torch.core.query import query_count

    bvh, pred = _identity_setup(fast, dev)
    return [Call(f"query_count[{backend}]",
                 lambda b, p, be=backend: query_count(b, p, backend=be),
                 (bvh, pred), None, None)
            for backend in ("stackless", "stack")]


def _stats_path_identity(fast: bool, dev) -> list[Finding]:
    """The obs layer's zero-cost contract: with ``with_stats=False`` the
    engine must run the exact uninstrumented program. Compares the live
    ``query_count`` path against the frozen twin in
    ``staticcheck/frozen_query.py`` op for op, for the rope and the stack
    walk; on the card the stats-off call must also launch no counter
    instance of COUNT."""
    from repro_torch.core.query import query_count
    from repro_torch.kernels.wavefront import wavefront_count
    from repro_torch.staticcheck.frozen_query import (frozen_count_stack,
                                                      frozen_count_stackless)

    bvh, pred = _identity_setup(fast, dev)
    findings: list[Finding] = []
    for backend, frozen in (("stackless", frozen_count_stackless),
                            ("stack", frozen_count_stack)):
        before = wavefront_count.counters.launches
        live = op_signature(
            lambda b, p: query_count(b, p, backend=backend), (bvh, pred))
        counters = wavefront_count.counters.launches - before
        ref = op_signature(frozen, (bvh, pred))
        if counters:
            findings.append(Finding(
                rule="stats-path-identity",
                path=f"<ops:query_count[{backend}]>", line=0,
                message=(f"with_stats=False launched COUNT's counter "
                         f"instance {counters} times")))
        if live == ref:
            continue
        divergence = next(
            (i for i, (a, b) in enumerate(zip(live, ref)) if a != b),
            min(len(live), len(ref)))
        findings.append(Finding(
            rule="stats-path-identity",
            path=f"<ops:query_count[{backend}]>", line=0,
            message=(
                f"with_stats=False path diverged from the frozen "
                f"uninstrumented program at op {divergence} "
                f"(live {len(live)} ops vs frozen {len(ref)}; "
                f"live[{divergence}]="
                f"{live[divergence] if divergence < len(live) else '<end>'}, "
                f"frozen[{divergence}]="
                f"{ref[divergence] if divergence < len(ref) else '<end>'}): "
                f"counter arithmetic is leaking into the stats-off hot "
                f"path, or the engine changed without updating "
                f"staticcheck/frozen_query.py")))
    return findings


def _obs_stats_calls(fast: bool, dev) -> list[Call]:
    """The stats-ON entry points under the device-discipline rules:
    instrumented traversal must stage no dense buffer, and read the host
    only where its code says. The rope walk's counters need
    ``node_depths``'s table, a boolean index and an indexed assignment of
    a Python number a level (``core/bvh.py:189-193``), as many levels as
    the tree's height; the stack walk is torch ops whose loop
    (``core/query.py:266-288``) makes one ``nonzero`` and nine boolean
    indexes a pass, as many passes as the longest walk's visits, which
    the call returns."""
    from repro_torch.core.query import query_count

    n, nq = (128, 32) if fast else (256, 64)
    bvh, pred = _skewed_workload(n, nq, dev)
    height = tree_height(bvh)

    def stack_allowance(result) -> int:
        return 10 * int(result[1].nodes_visited.max())

    return [
        Call("query_count_stats_stackless",
             lambda b, p: query_count(b, p, backend="stackless",
                                      with_stats=True),
             (bvh, pred), nq * n, 2 * height),
        Call("query_count_stats_stack",
             lambda b, p: query_count(b, p, backend="stack", with_stats=True),
             (bvh, pred), nq * n, stack_allowance),
    ]


def _wavefront_calls(fast: bool, dev) -> list[Call]:
    """``backend='pallas'`` (the port's stackless walk: on the card the
    wavefront kernel) under the device-discipline rules: the count pass
    and the CSR fill stage no dense buffer and read nothing back."""
    from repro_torch.core.query import query_count, query_csr_device

    n = nq = 128 if fast else 256
    bvh, pred = _skewed_workload(n, nq, dev)
    dense = nq * n
    return [
        Call("query_count_pallas",
             lambda b, p: query_count(b, p, backend="pallas"),
             (bvh, pred), dense, 0),
        Call("query_csr_device_pallas",
             lambda b, p: query_csr_device(b, p, capacity=n + 64, chunk=16,
                                           backend="pallas"),
             (bvh, pred), dense, 0),
    ]


REGISTERED_AUDITS: list[Audit] = [
    Audit("query_csr_device", calls=_csr_device_calls),
    Audit("kernels/wavefront_backend", calls=_wavefront_calls),
    Audit("fdbscan", calls=_fdbscan_calls),
    Audit("fdbscan_pair", calls=_fdbscan_pair_calls),
    Audit("halo_pipeline_sharded", calls=_halo_pipeline_calls),
    Audit("kernels/eps_neighbor_counts", calls=_pairwise_calls),
    Audit("serving/bucketed_recompiles", calls=_serving_calls,
          check=_serving_check),
    Audit("obs/stats_path_identity", calls=_identity_calls,
          check=_stats_path_identity),
    Audit("obs/query_stats_device", calls=_obs_stats_calls),
]


def run_registered_audits(fast: bool = False, device=None
                          ) -> tuple[list[Finding], list[str]]:
    """Every registered audit on ``device`` (``None``: the CUDA card):
    ``(findings, audit names)``."""
    findings: list[Finding] = []
    names: list[str] = []
    for audit in REGISTERED_AUDITS:
        names.append(audit.name)
        findings.extend(audit.run(fast, device))
    return findings, names
