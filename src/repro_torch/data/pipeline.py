"""Point-cloud helpers; port of ``repro/data/pipeline.py`` (the subset the
halo-finding path needs). numpy in, numpy out, as in the reference."""
from __future__ import annotations

import numpy as np

__all__ = ["make_clustered_points", "hacc_benchmark_epsilon"]


def make_clustered_points(rng: np.random.Generator, n: int, d: int = 3,
                          n_halos: int = 32, noise_frac: float = 0.2,
                          halo_scale: float = 0.05) -> np.ndarray:
    """NFW-like halo profiles + uniform background in [0,1)^d; the same
    draws from ``rng`` as the reference, so one seed gives one cloud."""
    n_noise = int(n * noise_frac)
    n_clustered = n - n_noise
    centers = rng.uniform(0.05, 0.95, (n_halos, d))
    w = rng.pareto(1.5, n_halos) + 1
    sizes = rng.multinomial(n_clustered, w / w.sum())
    parts = [rng.uniform(0.0, 1.0, (n_noise, d)).astype(np.float32)]
    for c, s in zip(centers, sizes):
        if s == 0:
            continue
        u = rng.uniform(0, 1, (s, 1)) ** 2.5
        direction = rng.standard_normal((s, d))
        direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-9)
        r = halo_scale * u * (0.3 + rng.uniform(0, 1, (n_halos,))[0])
        # N-body particles never coincide: a floor on the radius.
        r = np.maximum(r, 5e-5)
        parts.append((c + r * direction).astype(np.float32))
    pts = np.concatenate(parts)
    return np.clip(pts, 0.0, 1.0 - 1e-6).astype(np.float32)


def hacc_benchmark_epsilon(volume: float, n_particles: int, b: float = 0.168) -> float:
    """The paper's linking length: ε = b (V/n)^{1/3}."""
    return b * (volume / n_particles) ** (1.0 / 3.0)
