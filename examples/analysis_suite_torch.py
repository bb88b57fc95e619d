"""The full ArborX analysis surface on one dataset (paper §3.2) on the
PyTorch/CUDA port, the twin of ``examples/analysis_suite.py``: kNN,
Euclidean MST, 2-point correlation, MLS interpolation and ray casting.

  PYTHONPATH=src python examples/analysis_suite_torch.py [--device cpu]

The default device is the CUDA card. It checks that each point is its own
nearest neighbour, that the MST's n - 1 edges span the points, that the
MLS interpolant is within 0.1 of the field, and that every ray's hit is
the nearest along it of the boxes it pierces; ``tests/test_torch_analysis_suite.py``
holds its values against the reference example's.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (build_bvh, build_bvh_objects, emst, knn,
                              mls_interpolate, raycast, raycast_all,
                              two_point_correlation)
from repro_torch.core.union_find import connected_components
from repro_torch.data.pipeline import make_clustered_points
from repro_torch.device import resolve_device

N = 512


def field(p):
    return (np.sin(4 * p[:, 0]) + p[:, 1] ** 2).astype(np.float32)


def run(device=None) -> dict:
    """The reference example's five analyses on ``device``."""
    dev = resolve_device(device)
    pts = make_clustered_points(np.random.default_rng(2), N)
    tp = torch.from_numpy(pts).to(dev)
    lo, hi = pts.min(0) - 1e-4, pts.max(0) + 1e-4
    scene = (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))
    bvh = build_bvh(tp, *scene)
    out = {"pts": pts}
    # Nearest search (§3.2 "range and nearest").
    out["knn"] = knn(bvh, tp, tp[:8], k=4)
    # Euclidean MST (ArborX's clustering functionality).
    out["emst"] = emst(tp, device=dev)
    # 2-point correlation (§4.2.3's pair-operation example).
    out["xi"], _, _ = two_point_correlation(tp, r_max=0.25, n_bins=8, device=dev)
    # MLS interpolation (§3.2 interpolation functionality).
    targets = np.random.default_rng(3).uniform(0.2, 0.8, (5, 3)).astype(np.float32)
    out["targets"] = targets
    out["mls"] = mls_interpolate(tp, field(pts), targets, k=10, device=dev)
    # Ray casting (§3.2 ray tracing functionality).
    box_lo = torch.from_numpy(pts[:64] - 0.01).to(dev)
    box_hi = torch.from_numpy(pts[:64] + 0.01).to(dev)
    rbvh = build_bvh_objects(box_lo, box_hi, *scene)
    origins = torch.zeros((4, 3), dtype=torch.float32, device=dev)
    dirs = torch.from_numpy(pts[:4] / np.linalg.norm(pts[:4], axis=1,
                                                     keepdims=True)).to(dev)
    out["rays"] = raycast(rbvh, origins, dirs)
    out["ray_rows"] = raycast_all(rbvh, origins, dirs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    res = run(ap.parse_args(argv).device)
    nn, tree, hits = res["knn"], res["emst"], res["rays"]
    print("kNN: first point's 4 nearest:", nn.indices[0].tolist(),
          "dists", np.round(nn.distances[0].cpu().numpy(), 4))
    print(f"EMST: {int((tree.edges >= 0).all(1).sum())} edges, total weight "
          f"{float(tree.total_weight):.3f}, Boruvka rounds {int(tree.rounds)}")
    print("xi(r) per bin:", np.round(res["xi"], 2),
          "(clustered => xi >> 0 at small r)")
    err = np.abs(res["mls"].cpu().numpy() - field(res["targets"]))
    print("MLS interp err:", np.round(err, 4))
    print("raycast hits:", hits.index.tolist(), "t:",
          np.round(hits.t.cpu().numpy(), 3))

    assert nn.indices[:, 0].tolist() == list(range(8))
    labels = connected_components(N, tree.edges[:, 0], tree.edges[:, 1])
    assert tree.edges.shape == (N - 1, 2) and bool((labels == 0).all())
    assert err.max() < 0.1
    rows = res["ray_rows"]
    for i, (j, t) in enumerate(zip(hits.index.tolist(), hits.t.tolist())):
        row = rows.indices[rows.offsets[i]:rows.offsets[i + 1]].tolist()
        assert (j in row) if j >= 0 else not row
    print("\nOK: self first in kNN, the MST spans, MLS within 0.1, every "
          "nearest hit among its ray's hits")


if __name__ == "__main__":
    main()
