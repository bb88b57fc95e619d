"""Figure 2 on the PyTorch/CUDA port, the twin of
``examples/galaxy_finding.py``: in-situ substructure ("galaxy") finding.

The paper clusters stellar particles with DBSCAN minPts=10 inside the
largest dark-matter halo and draws a circle per galaxy (radius = farthest
member from the centroid). Same analysis here on the synthetic benchmark
cloud (1536 points, seed 7): FOF (minPts=2) at 1.5 eps finds the halos,
then DBSCAN minPts=10 at eps inside the largest one. Prints per-galaxy
radii and membership (the data behind the figure).

  PYTHONPATH=src python examples/galaxy_finding_torch.py [--device cpu]

The default device is the CUDA card.
"""
import argparse
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dbscan import DbscanResult, fdbscan
from repro_torch.data.pipeline import hacc_benchmark_epsilon, make_clustered_points
from repro_torch.device import as_tensor_on, resolve_device

N = 1536
SEED = 7
FOF_SCALE = 1.5
MIN_PTS = 10


class Galaxies(NamedTuple):
    halos: DbscanResult     # FOF over every point
    members: torch.Tensor   # (m,) int64 indices of the largest halo's points
    galaxies: DbscanResult  # DBSCAN over those points, in ``members`` order


def make_points():
    """The reference example's cloud and eps."""
    pts = make_clustered_points(np.random.default_rng(SEED), N, n_halos=6,
                                noise_frac=0.15)
    return pts, hacc_benchmark_epsilon(1.0, N)


def find_galaxies(points, eps, *, device=None) -> Galaxies:
    """FOF (``min_pts=2``) at ``FOF_SCALE * eps`` over ``points``, then
    DBSCAN with ``MIN_PTS`` at ``eps`` inside the largest halo (the
    smallest root among equally large ones), on ``device`` (``None``: the
    CUDA card)."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    halos = fdbscan(points, eps * FOF_SCALE, 2, device=dev)
    labels = halos.labels
    ids, counts = torch.unique(labels[labels >= 0], return_counts=True)
    biggest = ids[counts.argmax()]
    members = torch.nonzero(labels == biggest).flatten()
    galaxies = fdbscan(points[members], eps, MIN_PTS, device=dev)
    return Galaxies(halos=halos, members=members, galaxies=galaxies)


def run(device=None) -> Galaxies:
    """The example's analysis on ``device``."""
    pts, eps = make_points()
    return find_galaxies(pts, eps, device=device)


def report(res: Galaxies) -> None:
    """Print the example's report of ``res``: the largest halo, then each
    galaxy's size, center and radius (the first ten)."""
    pts, _ = make_points()
    labels = res.halos.labels.cpu().numpy()
    n_halos = len(np.unique(labels[labels >= 0]))
    members = pts[res.members.cpu().numpy()]
    print(f"largest halo: {len(members)} particles (of {N}, {n_halos} "
          f"halos found)")
    glabels = res.galaxies.labels.cpu().numpy()
    gids = np.unique(glabels[glabels >= 0])
    print(f"{len(gids)} galaxies found, {int((glabels < 0).sum())} stellar noise")
    for g in gids[:10]:
        m = members[glabels == g]
        center = m.mean(0)
        radius = np.linalg.norm(m - center, axis=1).max()
        print(f"  galaxy {g}: {len(m):5d} stars, center={np.round(center, 3)}, "
              f"radius={radius:.4f}")
    assert len(gids) >= 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    report(run(args.device))


if __name__ == "__main__":
    main()
