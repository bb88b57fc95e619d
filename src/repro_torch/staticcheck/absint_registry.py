"""Registered scale-safety (absint) audits; port of
``repro/staticcheck/absint_registry.py``: the port's device pipelines, each
staged at small marker sizes and re-read at **symbolic exascale N** (1e9
points, 64 shards, avg degree 64) by the abstract interpreter.

Two families live here:

* ``REGISTERED_ABSINT_AUDITS`` — the production configurations (int64
  index dtypes where capacity crosses 2^31). These must analyze CLEAN at
  symbolic N, with no unknown op; any finding is a CI failure
  (``python -m repro_torch.staticcheck --absint``).
* ``SEEDED_FIXTURES`` — the broken twins (int32 indices at 64e9 total
  hits, the f32 min-image fold of BIG ghost fills, an f32 cancellation,
  an unclipped sentinel gather, a colliding ``ppermute`` route). Each must
  fire EXACTLY its seeded rule — they pin the analyzer's recall the same
  way the clean audits pin its precision.

Sizes are markers, not workloads: ``N_STAGE = 254`` points stage the run,
``scale_for(N_STAGE, N_SYM)`` re-reads every shape and literal equal to a
marker at the symbolic size. Each audit runs its entry point once, on the
card by default (``device=``), with the kernels' outputs taken whole; no
large array is ever made.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.staticcheck.absint import (AbsintReport, SymbolicScale,
                                            analyze, scale_for)
from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.lattice import Ival

__all__ = [
    "AbsintAudit",
    "REGISTERED_ABSINT_AUDITS",
    "SEEDED_FIXTURES",
    "run_absint_audits",
    "absint_coverage",
    "N_STAGE",
    "N_SYM",
    "AVG_DEGREE",
    "N_SHARDS",
    "bvh_scale",
]

N_STAGE = 254          # staged marker size (distinct from small constants)
N_SYM = 10**9          # the paper's exascale point count
AVG_DEGREE = 64        # mean neighbors/query -> 64e9 total CSR hits
N_SHARDS = 64          # symbolic mesh width
_CSR_CAP = 318         # staged capacity marker for the CSR paths
_SHARD_CAP = 322       # staged capacity marker for the sharded path
_HALO_CAP = 33


@dataclasses.dataclass(frozen=True)
class AbsintAudit:
    """One symbolic-scale analysis of a registered entry point.

    ``run(device)`` returns the ``AbsintReport``; ``expect_rules`` is the
    exact set of rule names that must fire (empty for the clean production
    configs).
    """
    name: str
    run: Callable[[torch.device], AbsintReport]
    expect_rules: tuple = ()


def _points(device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.random((N_STAGE, 3),
                                      dtype=np.float32)).to(device)


def _csr_args(device):
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.core.query import within

    pts = _points(device)
    bvh = build_bvh(pts, *scene_bounds(pts))
    pred = within(pts, 0.1)
    counts = torch.zeros((N_STAGE,), dtype=torch.int32, device=device)
    return bvh, pred, counts


def _csr_scale() -> SymbolicScale:
    return SymbolicScale(dims=scale_for(
        N_STAGE, N_SYM,
        {_CSR_CAP: AVG_DEGREE * N_SYM, _CSR_CAP + 1: AVG_DEGREE * N_SYM + 1}))


def _run_csr(device, index_dtype) -> AbsintReport:
    from repro_torch.core.query import query_csr_device

    bvh, pred, counts = _csr_args(device)
    return analyze(
        lambda b, p, c: query_csr_device(b, p, _CSR_CAP, counts=c,
                                         index_dtype=index_dtype),
        (bvh, pred, counts),
        name=f"query_csr_device[{str(index_dtype).removeprefix('torch.')}]",
        scale=_csr_scale(),
        # per-query hit counts: anything up to the capacity marker — it is
        # the 1e9-query cumsum that must not overflow the offsets dtype
        input_ivals=[None, None, Ival(0, 2048)])


def _audit_csr_int64(device) -> AbsintReport:
    return _run_csr(device, torch.int64)


def _fixture_csr_int32(device) -> AbsintReport:
    return _run_csr(device, torch.int32)


def bvh_scale(n: int = N_STAGE, n_sym: int = N_SYM) -> SymbolicScale:
    """The marker family of a run that builds its tree over ``n`` points:
    ``scale_for``'s, plus n - 2, the last internal node, which the build
    clamps its split positions to."""
    return SymbolicScale(dims=scale_for(n, n_sym, {n - 2: n_sym - 2}))


def _run_dbscan(device, pair: bool) -> AbsintReport:
    from repro_torch.core.dbscan import fdbscan, fdbscan_pair

    fn = fdbscan_pair if pair else fdbscan
    return analyze(lambda p: fn(p, 0.05, 2, device=device), (_points(device),),
                   name="fdbscan_pair" if pair else "fdbscan",
                   scale=bvh_scale(), input_ivals=[Ival(0.0, 1.0)])


def _audit_fdbscan(device) -> AbsintReport:
    return _run_dbscan(device, pair=False)


def _audit_fdbscan_pair(device) -> AbsintReport:
    return _run_dbscan(device, pair=True)


def _audit_morton_sort(device) -> AbsintReport:
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.core.morton import (morton64, normalize_points,
                                         sort_by_morton64)

    return analyze(
        lambda p: sort_by_morton64(morton64(
            normalize_points(p, *scene_bounds(p)))),
        (_points(device),), name="morton_sort",
        scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM)),
        input_ivals=[Ival(0.0, 1.0)])


def _run_sharded(device, index_dtype) -> AbsintReport:
    from repro_torch.core.distributed import sharded_neighbor_csr
    from repro_torch.core.mesh import ShardMesh

    rng = np.random.default_rng(1)
    pts = torch.as_tensor(np.sort(rng.random((N_STAGE, 3), dtype=np.float32),
                                  axis=0)).to(device)
    mesh = ShardMesh(1, device)
    dims = scale_for(N_STAGE, N_SYM,
                     {_SHARD_CAP: AVG_DEGREE * N_SYM,
                      _SHARD_CAP + 1: AVG_DEGREE * N_SYM + 1})
    return analyze(
        lambda p: sharded_neighbor_csr(p, 0.05, capacity=_SHARD_CAP,
                                       mesh=mesh, halo_cap=_HALO_CAP,
                                       index_dtype=index_dtype),
        (pts,),
        name=f"sharded_neighbor_csr[{str(index_dtype).removeprefix('torch.')}]",
        scale=SymbolicScale(dims=dims, axes={"data": N_SHARDS}),
        input_ivals=[Ival(0.0, 1.0)])


def _audit_sharded_int64(device) -> AbsintReport:
    return _run_sharded(device, torch.int64)


def _fixture_sharded_int32(device) -> AbsintReport:
    return _run_sharded(device, torch.int32)


def _fixture_min_image_f32(device) -> AbsintReport:
    """The periodic-boundary fold applied to the BIG=1e15 ghost fill in
    f32: round() of an operand past 2^24 has ulp spacing > 1, so
    ``round(BIG/L)*L == BIG`` and the fold is an identity. The analyzer
    must derive this from the interval, not from a pattern."""
    L = 100.0

    def min_image(dx):
        # the deliberately-broken twin; the analyzer must rediscover R4's
        # trap from intervals alone  # staticcheck: minimage-ok
        return dx - torch.round(dx / L) * L

    dx = torch.zeros((N_STAGE,), dtype=torch.float32, device=device)
    return analyze(min_image, (dx,), name="min_image_f32",
                   scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM)),
                   input_ivals=[Ival(-1.0e15, 1.0e15)])


def _fixture_cancellation(device) -> AbsintReport:
    """Catastrophic cancellation under a precision floor: subtracting
    overlapping ~1e9-magnitude f32 intervals leaves ~128 absolute error —
    fatal when the caller needs 1e-3 (velocity-dispersion style sums)."""
    a = torch.zeros((N_STAGE,), dtype=torch.float32, device=device)
    return analyze(lambda x, y: x - y, (a, a), name="cancellation_f32",
                   scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM),
                                       precision_floor=1e-3),
                   input_ivals=[Ival(1.0e9, 1.1e9), Ival(1.0e9, 1.1e9)])


def _fixture_sentinel_gather(device) -> AbsintReport:
    """A neighbor list whose "no neighbor" sentinel is ``n`` used directly
    as a gather index: at symbolic N the index interval [0, N] is not
    inside [-N, N-1]. The fix — clip or a sentinel-aware where — analyzes
    clean (see tests/test_torch_absint.py)."""
    labels = torch.zeros((N_STAGE,), dtype=torch.int32, device=device)
    idx = torch.zeros((N_STAGE,), dtype=torch.int64, device=device)
    return analyze(lambda lab, i: lab[i], (labels, idx),
                   name="sentinel_gather",
                   scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM)),
                   input_ivals=[Ival(0, 100), Ival(0, N_SYM)])


def _fixture_bad_route(device) -> AbsintReport:
    """A halo exchange whose ppermute routes two sources onto one
    destination — not a partial permutation; one shard's halo is silently
    dropped."""
    from repro_torch.core.mesh import ShardMesh

    mesh = ShardMesh(1, device)

    def exchange(x):
        return torch.cat(mesh.run(
            lambda axis, xs: axis.ppermute(xs, [(0, 0), (0, 0)]), x))

    return analyze(exchange, (_points(device),), name="bad_route",
                   scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM),
                                       axes={"data": N_SHARDS}),
                   input_ivals=[Ival(0.0, 1.0)])


def _audit_wavefront_pallas(device) -> AbsintReport:
    """The stackless backend (the reference's Pallas one) at symbolic N:
    the bookkeeping around the kernel (the Morton thread order, its sort
    and int32 convert) must prove its index widths like every other path;
    the kernel's outputs take their dtype's range — soundly silent, never
    a false positive."""
    from repro_torch.core.query import query_count

    bvh, pred, _ = _csr_args(device)
    return analyze(
        lambda b, p: query_count(b, p, backend="pallas", sort_queries=True),
        (bvh, pred),
        name="query_count[pallas]",
        scale=SymbolicScale(dims=scale_for(N_STAGE, N_SYM)))


REGISTERED_ABSINT_AUDITS: list[AbsintAudit] = [
    AbsintAudit("query_csr_device/int64", _audit_csr_int64),
    AbsintAudit("query_count/pallas", _audit_wavefront_pallas),
    AbsintAudit("fdbscan", _audit_fdbscan),
    AbsintAudit("fdbscan_pair", _audit_fdbscan_pair),
    AbsintAudit("morton_sort", _audit_morton_sort),
    AbsintAudit("sharded_neighbor_csr/int64", _audit_sharded_int64),
]

# name -> (audit, the one rule that must fire). The int32 configurations
# are real code paths (``index_dtype=torch.int32``, the default), not
# synthetic ASTs: the analyzer rediscovers each trap from intervals alone.
SEEDED_FIXTURES: list[AbsintAudit] = [
    AbsintAudit("query_csr_device/int32@64e9", _fixture_csr_int32,
                expect_rules=("W1-index-width",)),
    AbsintAudit("sharded_neighbor_csr/int32@64shards", _fixture_sharded_int32,
                expect_rules=("W1-index-width",)),
    AbsintAudit("min_image/f32@BIG", _fixture_min_image_f32,
                expect_rules=("W2-precision",)),
    AbsintAudit("cancellation/f32@floor", _fixture_cancellation,
                expect_rules=("W2-precision",)),
    AbsintAudit("sentinel_gather/unclipped", _fixture_sentinel_gather,
                expect_rules=("W3-bounds",)),
    AbsintAudit("halo_exchange/bad_route", _fixture_bad_route,
                expect_rules=("W3-routes",)),
]


def run_absint_audits(fast: bool = False, device=None):
    """Run the registered (clean) audits on ``device`` (``None``: the CUDA
    card; raises without one). Returns ``(findings, reports)`` where
    ``findings`` fold into the staticcheck exit code and ``reports`` carry
    the per-entrypoint coverage counters."""
    dev = resolve_device(device)
    findings: list[Finding] = []
    reports: list[AbsintReport] = []
    audits = REGISTERED_ABSINT_AUDITS
    if fast:
        # the sharded run dominates wall time; --fast keeps the rest
        audits = [a for a in audits if not a.name.startswith("sharded")]
    for audit in audits:
        rep = audit.run(dev)
        reports.append(rep)
        findings.extend(rep.findings)
    return findings, reports


_COVERAGE_CACHE: dict = {}


def absint_coverage(device=None) -> dict:
    """Benchmark-artifact metadata block: one fast registered-audit pass,
    memoized per process and device. ``seconds: 0.0`` keeps it out of any
    timing gate."""
    dev = resolve_device(device)
    if dev not in _COVERAGE_CACHE:
        findings, reports = run_absint_audits(fast=True, device=dev)
        _COVERAGE_CACHE[dev] = {
            "seconds": 0.0,
            "rules": ["W1-index-width", "W2-precision", "W3-bounds/routes"],
            "entrypoints": [r.name for r in reports],
            "values_analyzed": int(sum(r.values_analyzed for r in reports)),
            "findings": len(findings),
        }
    return dict(_COVERAGE_CACHE[dev])
