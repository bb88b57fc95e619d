"""End-to-end halo products on the PyTorch/CUDA port, the twin of
``examples/halo_catalog.py``.

Synthetic Plummer-sphere halos with self-consistent velocity dispersions
plus uniform background noise -> FDBSCAN labels -> fixed-capacity halo
catalog -> most-bound centers (2ε) -> spherical-overdensity masses
(Δ = 200, r_max = 0.1), one BVH serving both products. It checks that
every big halo's velocity dispersion is within 25% of its sphere's input
dispersion, that every most-bound particle is a member of its halo and
that every SO radius is bracketed. The catalog itself is held against
the reference's numpy oracle by ``tests/test_torch_centers.py``.

  PYTHONPATH=src python examples/halo_catalog_torch.py [--device cpu]

The default device is the CUDA card.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.bvh import build_bvh
from repro_torch.core.dbscan import fdbscan
from repro_torch.core.geometry import scene_bounds
from repro_torch.halos import halo_catalog, most_bound_centers, so_masses
from repro_torch.kernels.wavefront import shared_pack

N_SPHERES = 5
N_PER = 350
N_NOISE = 250
CAPACITY = 64
MIN_PTS = 8
EPS = 0.008


def plummer_sphere(rng, n, center, a=0.01, mtot=1.0):
    """Plummer (1911) profile: r from the inverse CDF, isotropic positions,
    Maxwellian velocities at the local dispersion σ²(r) ∝ (r² + a²)^(-1/2)."""
    u = rng.uniform(0.02, 0.98, n)
    r = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = rng.standard_normal((n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    pos = center + r[:, None] * direction
    sigma2 = mtot / (6.0 * np.sqrt(r ** 2 + a ** 2))  # G = 1
    vel = rng.standard_normal((n, 3)) * np.sqrt(sigma2)[:, None]
    return pos.astype(np.float32), vel.astype(np.float32)


def make_particles(seed: int = 42):
    """The reference example's particles: ``(points, velocities, sphere
    centers, each sphere's input velocity dispersion)``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (N_SPHERES, 3))
    parts_p, parts_v, truth_sigma = [], [], []
    for c in centers:
        p, v = plummer_sphere(rng, N_PER, c)
        parts_p.append(p)
        parts_v.append(v)
        truth_sigma.append(np.sqrt((v ** 2).sum(1).mean()
                                   - (v.mean(0) ** 2).sum()))
    parts_p.append(rng.uniform(0, 1, (N_NOISE, 3)).astype(np.float32))
    parts_v.append(np.zeros((N_NOISE, 3), np.float32))
    pts = np.clip(np.concatenate(parts_p), 0.0, 1.0 - 1e-6)
    return pts, np.concatenate(parts_v), centers, truth_sigma


def run(pts, vel, device=None):
    """FDBSCAN -> catalog -> one BVH -> most-bound centers -> SO masses on
    ``device``. Returns ``(dbscan result, catalog, most-bound, SO)``."""
    res = fdbscan(pts, EPS, MIN_PTS, device=device)
    cat = halo_catalog(pts, vel, res.labels, capacity=CAPACITY,
                       min_count=MIN_PTS, device=device)
    pts_t = torch.as_tensor(pts, device=res.labels.device)
    bvh = build_bvh(pts_t, *scene_bounds(pts_t))
    # Both products walk one packed copy of the tree.
    with shared_pack(bvh):
        mb = most_bound_centers(pts_t, cat.particle_halo, EPS * 2,
                                capacity=CAPACITY, bvh=bvh, device=device)
        so = so_masses(pts_t, mb.center, cat.count > 0, delta=200.0,
                       r_max=0.1, bvh=bvh, device=device)
    return res, cat, mb, so


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    pts, vel, centers, truth_sigma = make_particles()
    res, cat, mb, so = run(pts, vel, args.device)
    labels = res.labels.cpu().numpy()
    print(f"{len(pts)} particles -> {len(np.unique(labels[labels >= 0]))} "
          f"clusters, {int((labels < 0).sum())} noise")

    nh = int(cat.num_halos)
    count, center = cat.count.cpu().numpy(), cat.center.cpu().numpy()
    vdisp, rmax = cat.vdisp.cpu().numpy(), cat.rmax.cpu().numpy()
    m200, r200 = so.m_delta.cpu().numpy(), so.r_delta.cpu().numpy()
    print(f"\n{'halo':>4} {'count':>6} {'sigma_v':>8} {'sigma_in':>8} "
          f"{'rmax':>7} {'M200':>7} {'R200':>7}")
    order = np.argsort(-count[:nh])
    for h in order:
        # match recovered halo to the nearest input sphere
        k = int(np.argmin(((centers - center[h]) ** 2).sum(1)))
        print(f"{h:>4} {count[h]:>6} {vdisp[h]:>8.4f} {truth_sigma[k]:>8.4f} "
              f"{rmax[h]:>7.4f} {m200[h]:>7.1f} {r200[h]:>7.4f}")

    # dispersion recovery: every big halo within 25% of its sphere's truth
    for h in order:
        if count[h] < 0.5 * N_PER:
            continue
        k = int(np.argmin(((centers - center[h]) ** 2).sum(1)))
        rel = abs(vdisp[h] - truth_sigma[k]) / truth_sigma[k]
        assert rel < 0.25, (h, rel)
    assert nh >= 1
    idx = mb.index.cpu().numpy()[:nh]
    halo_of = cat.particle_halo.cpu().numpy()
    assert (idx >= 0).all() and (halo_of[idx] == np.arange(nh)).all()
    assert bool(so.bracketed[:nh].all())
    print("\nOK: dispersions recovered, most-bound centers are members, "
          "SO masses computed and bracketed")


if __name__ == "__main__":
    main()
