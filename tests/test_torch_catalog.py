"""The port's halo catalog on the CPU against the JAX reference, with its
scatter path and with its Pallas segment kernels in interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.halos.catalog import halo_catalog as jax_halo_catalog  # noqa: E402
from repro_torch.halos.catalog import halo_catalog  # noqa: E402


@pytest.fixture(scope="module")
def labelled():
    rng = np.random.default_rng(11)
    pts = make_clustered_points(rng, 1200, n_halos=6)
    vel = rng.standard_normal((len(pts), 3)).astype(np.float32)
    labels = np.asarray(jax_fdbscan(jnp.asarray(pts), 0.025, 4).labels)
    return pts, vel, labels


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("capacity", [64, 3])
def test_catalog_matches_reference(labelled, backend, capacity):
    pts, vel, labels = labelled
    want = jax_halo_catalog(jnp.asarray(pts), jnp.asarray(vel),
                            jnp.asarray(labels), capacity=capacity,
                            min_count=5, particle_mass=0.5, backend=backend)
    got = halo_catalog(pts, vel, labels, capacity=capacity, min_count=5,
                       particle_mass=0.5, device="cpu")
    assert bool(got.overflow) == bool(want.overflow) == (capacity == 3)
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        if w.dtype.kind == "f":
            # Per-halo sums of a few hundred float32 terms, added in another
            # order (scatter-add vs one-hot product): rounding only.
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)
