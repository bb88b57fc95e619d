"""The port's union-find against the JAX reference: labels (the minimum
vertex id of each component) equal on random edge lists with masks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import union_find as juf  # noqa: E402
from repro_torch.core import union_find  # noqa: E402


def _edges(seed, n, m, masked):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m).astype(np.int32)
    # Mostly short edges in a shuffled numbering: chains that need rounds.
    v = np.clip(u + rng.integers(-3, 4, m), 0, n - 1).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    u, v = perm[u], perm[v]
    mask = rng.random(m) < 0.7 if masked else np.ones(m, bool)
    return u, v, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_connected_components_equal_reference(seed, masked):
    n, m = 400, 300 + 100 * seed
    u, v, mask = _edges(seed, n, m, masked)
    want = juf.connected_components(n, jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(mask))
    got = union_find.connected_components(
        n, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    labels = got.numpy()
    assert (labels <= np.arange(n)).all()
    assert (labels[u[mask]] == labels[v[mask]]).all()


def test_connected_components_without_mask_and_without_edges():
    u, v, _ = _edges(3, 50, 60, False)
    want = juf.connected_components(50, jnp.asarray(u), jnp.asarray(v))
    got = union_find.connected_components(50, torch.from_numpy(u),
                                          torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = torch.zeros(0, dtype=torch.int32)
    np.testing.assert_array_equal(
        union_find.connected_components(7, none, none).numpy(), np.arange(7))


def test_hook_min_round_and_canonicalize_equal_reference():
    n = 64
    rng = np.random.default_rng(4)
    parent = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)
    u, v, mask = _edges(5, n, 80, True)
    want = juf.hook_min(jnp.asarray(parent), jnp.asarray(u), jnp.asarray(v),
                        jnp.asarray(mask))
    got = union_find.hook_min(torch.from_numpy(parent), torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Every edge masked out: nothing moves.
    same = union_find.hook_min(torch.from_numpy(parent), torch.from_numpy(u),
                               torch.from_numpy(v),
                               torch.zeros(len(u), dtype=torch.bool))
    np.testing.assert_array_equal(same.numpy(), parent)
    np.testing.assert_array_equal(
        union_find.canonicalize(torch.from_numpy(parent).long()).numpy(),
        np.asarray(juf.canonicalize(jnp.asarray(parent))))
