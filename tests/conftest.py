"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the real single CPU device. Only launch/dryrun.py
sets --xla_force_host_platform_device_count (in its own process)."""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest

# Optional dev dependency: the property tests import hypothesis at module
# scope, which used to crash the ENTIRE collection when it wasn't installed.
# Fall back to the deterministic shim (see _hypothesis_shim.py) so the suite
# always runs; install requirements-dev.txt for the real thing.
try:  # pragma: no cover - trivial import probe
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        os.path.join(os.path.dirname(__file__), "_hypothesis_shim.py"))
    _shim = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shim)
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies


def abstract_mesh(sizes, names):
    """AbstractMesh across JAX versions: <=0.4.x takes ((name, size), ...)
    pairs; newer releases take (sizes, names)."""
    import jax
    try:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))


def make_clustered_points(rng: np.random.Generator, n: int, d: int = 3,
                          n_halos: int = 4, noise_frac: float = 0.25) -> np.ndarray:
    """Clustered point set qualitatively matching the paper's benchmark data:
    dense NFW-like blobs (halos) + uniform background noise in [0, 1)^d."""
    n_noise = int(n * noise_frac)
    n_clustered = n - n_noise
    centers = rng.uniform(0.15, 0.85, (n_halos, d))
    sizes = rng.multinomial(n_clustered, np.ones(n_halos) / n_halos)
    parts = [rng.uniform(0.0, 1.0, (n_noise, d))]
    for c, s in zip(centers, sizes):
        # NFW-ish: radius ~ r0 * u^2 concentrates mass at the center.
        u = rng.uniform(0, 1, (s, 1)) ** 2
        direction = rng.normal(size=(s, d))
        direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-9)
        parts.append(c + 0.08 * u * direction)
    pts = np.concatenate(parts).astype(np.float32)
    return np.clip(pts, 0.0, 1.0 - 1e-6)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def clustered_points(rng):
    return make_clustered_points(rng, 400)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
