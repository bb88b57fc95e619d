"""Quickstart on the PyTorch/CUDA port, the twin of
``examples/quickstart.py``: the paper's contribution in a few calls.

Cluster a cosmology-style point cloud with FDBSCAN (the ArborX algorithm,
§4.3.3), tour the unified query API behind it (§4.1), its backends and
its observability, run the static checks, then cross-check against the
grid implementation. On the card every traversal is the hand-written
wavefront kernel and the grid runs the stencil kernels; on the CPU their
plain PyTorch versions, in seconds.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The default device is the CUDA card.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.bvh import build_bvh
from repro_torch.core.dbscan import NOISE, fdbscan
from repro_torch.core.fdbscan_grid import fdbscan_grid, grid_dims_for
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import (nearest, query, query_count, query_csr,
                                    query_csr_device, within)
from repro_torch.data.pipeline import hacc_benchmark_epsilon, make_clustered_points
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.staticcheck import audit_ops, lint_source, no_dense_intermediate

# --- the paper's benchmark setup, downscaled -------------------------------
# (demo scale, as the reference's: ε = b(V/n)^{1/3} at n = 37M maps to very
# fine grids, so n shrinks and ε widens to keep the same density regime.)
N = 512
MIN_PTS = 2                                                  # FOF
GRID_CAPACITY = 256

# The ROADMAP item 3 f32 trap, as the lint sees it.
MINIMAGE_SNIPPET = ("import torch\n"
                    "def fold(d, L):\n"
                    "    return d - torch.round(d / L) * L\n")


def make_points():
    points = make_clustered_points(np.random.default_rng(0), N)
    eps = 4 * hacc_benchmark_epsilon(volume=1.0, n_particles=N)  # b (V/n)^{1/3}
    return points, eps


def labels_equivalent(a: np.ndarray, b: np.ndarray, core: np.ndarray) -> bool:
    """Partition equality on CORE points plus the same noise set (a
    border point may join any adjacent cluster); a copy of the reference's
    ``ref_numpy.labels_equivalent``."""
    a, b = np.asarray(a), np.asarray(b)
    if ((a == NOISE) != (b == NOISE)).any():
        return False

    def canon(x):   # labels -> ids in order of first occurrence
        _, inv = np.unique(x, return_inverse=True)
        first: dict = {}
        return np.array([first.setdefault(v, len(first)) for v in inv],
                        np.int64)

    return bool((canon(a[core]) == canon(b[core])).all())


def index_sum(acc, q_idx, obj_idx, d2):
    """A fused callback: per ε-pair, add the neighbor's index (a lane
    batch of pairs per call; ``d2`` is the squared distance)."""
    return acc + obj_idx, False


def run(device=None, trace_path: str | None = None,
        grid_capacity: int | None = GRID_CAPACITY) -> dict:
    """Every section on ``device`` (``None``: the CUDA card); the results
    by name. ``grid_capacity=None`` leaves out the grid section (on the
    CPU its plain stencil tests every slot pair of 27 cells: minutes at
    the capacity of 256)."""
    dev = resolve_device(device)
    points, eps = make_points()
    out = {"points": points, "eps": eps}

    # --- faithful tier: BVH + stackless traversal + fused union-find -------
    out["fdbscan"] = fdbscan(points, eps, MIN_PTS, device=dev)

    # --- the query API -------------------------------------------------------
    # FDBSCAN above is a thin client of ONE engine (§4.1): build the tree
    # once, then dispatch any predicate against it.
    jp = torch.from_numpy(points).to(dev)
    bvh = build_bvh(jp, *scene_bounds(jp))
    # 1. range counts with early exit (DBSCAN's core test IS this call):
    out["counts"] = query_count(bvh, within(jp, eps), stop_at=MIN_PTS)
    # 2. neighbor lists as count-then-fill CSR; with no capacity, one host
    #    read sizes the output exactly:
    out["csr"] = query_csr(bvh, within(jp, eps))
    # 2b. the device-resident variant (the ArborX 2.0 contract): with a
    #     capacity bound, count -> scan -> fill stays on the device, with no
    #     host read, and overflow comes back as a flag:
    dev_csr = query_csr_device(bvh, within(jp, eps), capacity=64 * N)
    assert not bool(dev_csr.overflowed)
    assert int(dev_csr.total) == int(out["csr"].offsets[-1])
    out["csr_device"] = dev_csr
    # 3. a fused callback, no storage at all; it must agree with the CSR:
    out["index_sums"] = query(bvh, within(jp, eps), index_sum,
                              torch.zeros((), dtype=torch.int64),
                              sort_queries=True)
    assert int(out["index_sums"].sum()) == int(
        out["csr"].indices.sum(dtype=torch.int64))
    # 4. k nearest neighbors through the same dispatcher:
    out["knn"] = query(bvh, nearest(jp[:8], k=4))

    # 5. picking a backend. Every spatial call above takes `backend=`:
    #    "stackless" (default) the rope walk: on the card the wavefront
    #    kernel, a thread per query in Morton order; "pallas" the same walk
    #    (the reference's Pallas backend gives its stackless results);
    #    "stack" an explicit-stack walk in torch ops, a correctness oracle.
    out["counts_pallas"] = query_count(bvh, within(jp, eps), backend="pallas",
                                       sort_queries=True)
    assert torch.equal(out["counts_pallas"],
                       query_count(bvh, within(jp, eps), sort_queries=True))

    # --- observability -------------------------------------------------------
    # `with_stats=True` returns per-query traversal counters beside the
    # result (on the card, the kernel's counter instance), with zero cost
    # when off: the stats-off path is held op for op to the uninstrumented
    # one (`python -m repro_torch.staticcheck --ops`).
    _, stats = query_count(bvh, within(jp, eps), stop_at=MIN_PTS,
                           with_stats=True)
    out["stats"] = stats
    # Spans fence the device work, and export Chrome-trace JSON:
    tracer = SpanTracer()
    with tracer.span("quickstart_query", n=N) as sp:
        sp.fence(query_count(bvh, within(jp, eps)))
    if trace_path:
        tracer.export(trace_path)                   # load in ui.perfetto.dev
    reg = MetricsRegistry()
    reg.observe("quickstart/csr", dev_csr)          # -> total + overflow
    reg.observe("quickstart/query", stats)          # -> counter totals
    out["metrics"] = reg.summary()

    # --- static checks -------------------------------------------------------
    # The device-discipline rules this file leans on are machine-checked by
    # `repro_torch.staticcheck`:
    #
    #   PYTHONPATH=src python -m repro_torch.staticcheck            # AST lint
    #   PYTHONPATH=src python -m repro_torch.staticcheck --ops --fast --device cpu
    #
    # Prove the device CSR above never stages the dense (q x max_count)
    # buffer, then watch the lint catch the f32 min-image trap:
    out["audit"] = audit_ops(
        lambda b: query_csr_device(b, within(jp, eps), capacity=64 * N),
        (bvh,), [no_dense_intermediate(N * N)])
    assert out["audit"] == []
    out["lint"] = lint_source(MINIMAGE_SNIPPET, "snippet.py")

    # --- scale-safety checks -------------------------------------------------
    # The reference's third layer, an abstract interpreter that re-reads
    # the staged sizes as symbolic exascale N (index width, precision,
    # bounds), is not ported yet: ROADMAP A16.

    # --- grid tier: ε-cell binning + stencil kernels ---------------------------
    if grid_capacity is None:
        return out
    dims = grid_dims_for(np.zeros(3), np.ones(3), eps)
    res_g, overflowed = fdbscan_grid(
        points, eps, MIN_PTS, scene_lo=np.zeros(3, np.float32),
        grid_dims=dims, capacity=grid_capacity, device=dev)
    assert not bool(overflowed)
    out["grid"], out["grid_dims"] = res_g, dims
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--trace", default="trace_quickstart.json",
                    help="Chrome-trace path of the span demo")
    args = ap.parse_args(argv)
    out = run(args.device, trace_path=args.trace)
    res = out["fdbscan"]
    labels = res.labels.cpu().numpy()
    print(f"FDBSCAN:  {int((labels >= 0).sum())} clustered, "
          f"{int((labels < 0).sum())} noise, union rounds={int(res.num_rounds)}")
    print(f"query API: {int((out['counts'] >= MIN_PTS).sum())} core points, "
          f"CSR nnz={int(out['csr'].offsets[-1])}, "
          f"knn[0]={out['knn'].indices[0].cpu().numpy()}")
    tot = out["stats"].totals()
    print(f"traversal: {int(tot['nodes_visited'])} nodes, "
          f"{int(tot['callback_hits'])} hits, "
          f"{int(tot['early_exits'])} early exits, depth {int(tot['max_depth'])}")
    print(f"metrics: {sorted(out['metrics'])}")
    print("staticcheck demo:", out["lint"][0])
    glabels = out["grid"].labels.cpu().numpy()
    print(f"grid: {int((glabels >= 0).sum())} clustered "
          f"({int(np.prod(out['grid_dims']))} cells x 27-stencil)")
    assert labels_equivalent(labels, glabels, res.core_mask.cpu().numpy())
    print("faithful tier and grid tier agree.")


if __name__ == "__main__":
    main()
