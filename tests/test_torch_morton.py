"""The port's 30-bit Morton codes and their stable sort against the JAX
reference: codes bit-identical (the reference's uint32 as int64), sort
permutations equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import morton as jmorton  # noqa: E402
from repro_torch.core import morton  # noqa: E402


def _unit(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "clustered":
        return make_clustered_points(rng, 500)
    if kind == "bin_edges":
        # Exact bin boundaries k/1024, the top corner and the clamp.
        k = rng.integers(0, 1024, (300, 3))
        pts = (k / 1024.0).astype(np.float32)
        pts[:3] = np.float32(1.0) - np.finfo(np.float32).eps
        return pts
    # Coincident points: every code ties, the stable sort keeps index order.
    return np.full((40, 3), 0.3, np.float32)


@pytest.mark.parametrize("kind", ["clustered", "bin_edges", "coincident"])
def test_morton32_and_sort_bit_exact(kind):
    unit = _unit(kind)
    want = np.asarray(jmorton.morton32(jnp.asarray(unit)))
    got = morton.morton32(torch.from_numpy(unit))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < 1 << 30
    np.testing.assert_array_equal(
        morton.sort_by_morton32(got).numpy(),
        np.asarray(jmorton.sort_by_morton32(jnp.asarray(want))))
