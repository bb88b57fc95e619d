"""The port's nearest search (``knn``, ``query`` with ``Nearest`` and its
callback protocol, the generic ``traverse_nearest_stack``) on the CPU
against the JAX reference on the tree JAX built.

XLA:CPU contracts the reference's d² into fused multiply-adds and the
port does not (ROADMAP C8), so a distance may differ in its last bit and
near-ties may order differently. The queries here are tie-free: for each,
the k + 1 nearest squared distances (float64) differ pairwise by more
than 1e-5 relative. Indices are compared exactly, distances within
``rtol=2e-6``."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.knn import knn as jax_knn  # noqa: E402
from repro_torch.core.knn import knn  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402
from repro_torch.kernels import nearest as kn  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")

RTOL = 2e-6


def _cloud(seed=61, n=1024):
    return make_clustered_points(np.random.default_rng(seed), n)


def _trees(pts):
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    return jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


def tie_free(pts, queries, k):
    """Whether each query's k + 1 nearest squared distances (float64) are
    pairwise more than 1e-5 apart, relative."""
    d2 = ((queries[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    near = np.sort(d2, 1)[:, :min(k + 1, pts.shape[0])]
    return (np.diff(near, axis=1) > 1e-5 * near[:, 1:]).all(1)


def _queries(pts, k, m=200, seed=62):
    q = np.random.default_rng(seed).uniform(-0.05, 1.05, (m, 3)).astype(np.float32)
    q = q[tie_free(pts, q, k)]
    assert q.shape[0] > m // 2
    return q


def _assert_knn(got_idx, got_dist, want_idx, want_dist):
    np.testing.assert_array_equal(np.asarray(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(np.asarray(got_dist), np.asarray(want_dist),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_knn_matches_reference(k):
    """k = 40 is past the kernel's local-memory buffer (LOCAL_K)."""
    pts = _cloud()
    jb, tb = _trees(pts)
    q = _queries(pts, k)
    want = jax_knn(jb, jnp.asarray(pts), jnp.asarray(q), k)
    got = knn(tb, None, torch.from_numpy(q), k)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (q.shape[0], k)
    _assert_knn(got.indices, got.distances, want.indices, want.distances)


def test_knn_self_query():
    """A self-query: the point itself first, at distance 0."""
    pts = _cloud(seed=63, n=600)
    jb, tb = _trees(pts)
    keep = tie_free(pts, pts, 4)
    assert keep.sum() > 500
    want = jax_knn(jb, jnp.asarray(pts), jnp.asarray(pts), 4)
    tp = torch.from_numpy(pts)
    got = knn(tb, tp, tp, 4)
    np.testing.assert_array_equal(got.indices[:, 0].numpy(), np.arange(600))
    _assert_knn(got.indices[keep], got.distances[keep],
                np.asarray(want.indices)[keep], np.asarray(want.distances)[keep])


@pytest.mark.parametrize("sort_queries", [False, True])
def test_query_nearest_matches_reference(sort_queries):
    pts = _cloud(seed=64)
    jb, tb = _trees(pts)
    q = _queries(pts, 6, seed=65)
    want = jq.query(jb, jq.nearest(jnp.asarray(q), 6), sort_queries=sort_queries)
    got = tq.query(tb, tq.nearest(torch.from_numpy(q), 6),
                   sort_queries=sort_queries)
    assert isinstance(got, tq.NearestResult)
    _assert_knn(got.indices, got.distances, want.indices, want.distances)


def test_nearest_callback_protocol_with_done():
    """The callback runs per result in ascending distance with the
    Euclidean distance, and ``done`` stops the query: here at its first
    even neighbour index."""
    pts = _cloud(seed=66, n=500)
    jb, tb = _trees(pts)
    q = _queries(pts, 7, seed=67)
    k = 7

    def jcb(carry, qi, j, dist):
        n, s, acc = carry
        return (n + 1, s + j + qi, acc + dist), j % 2 == 0

    def tcb(carry, qi, j, dist):
        n, s, acc = carry
        return (n + 1, s + j + qi, acc + dist), j % 2 == 0

    want = jq.query(jb, jq.nearest(jnp.asarray(q), k), jcb,
                    (jnp.int32(0), jnp.int32(0), jnp.float32(0.0)))
    got = tq.query(tb, tq.nearest(torch.from_numpy(q), k), tcb,
                   (torch.tensor(0, dtype=torch.int32),
                    torch.tensor(0, dtype=torch.int32),
                    torch.tensor(0.0)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    assert 1 <= got[0].min() and got[0].max() <= k and got[0].min() < k


def test_nearest_callback_sums_the_k_best_distances():
    """The reference's protocol test: the sum of the k best distances."""
    rng = np.random.default_rng(23)
    pts = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    jb, tb = _trees(pts)
    want = jq.query(jb, jq.nearest(jnp.asarray(pts), 5),
                    lambda c, qi, j, d: (c + d, jnp.bool_(False)),
                    jnp.float32(0.0))
    got = tq.query(tb, tq.nearest(torch.from_numpy(pts), 5),
                   lambda c, qi, j, d: (c + d, False), torch.tensor(0.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_nearest_protocols_raise_as_the_reference():
    pts = _cloud(seed=68, n=60)
    jb, tb = _trees(pts)
    tp = torch.from_numpy(pts)
    jp = jnp.asarray(pts)
    for jpred, tpred in ((jq.nearest(jp, 3), tq.nearest(tp, 3)),
                         (jq.ray(jp, jp), tq.ray(tp, tp))):
        for jkw, tkw in (({"with_stats": True}, {"with_stats": True}),
                         ({"start_nodes": jnp.zeros(60, jnp.int32)},
                          {"start_nodes": torch.zeros(60, dtype=torch.int32)})):
            with pytest.raises(ValueError) as want:
                jq.query(jb, jpred, **jkw)
            with pytest.raises(ValueError) as got:
                tq.query(tb, tpred, **tkw)
            assert str(got.value) == str(want.value)


def test_traverse_nearest_stack_generic_matches_reference():
    """A walk of the reference's shape with callbacks of its own: the
    nearest object of odd index, best-so-far pruning in the push gate."""
    pts = _cloud(seed=69, n=700)
    jb, tb = _trees(pts)
    q = _queries(pts, 30, seed=70)

    def jpush(qd, carry, child, d2):
        return d2 < carry[0]

    def jleaf(qd, carry, obj, d2):
        hit = (obj % 2 == 1) & (d2 < carry[0])
        return jnp.where(hit, d2, carry[0]), jnp.where(hit, obj, carry[1])

    def tpush(qd, carry, child, d2):
        return d2 < carry[0]

    def tleaf(qd, carry, obj, d2):
        hit = (obj % 2 == 1) & (d2 < carry[0])
        return torch.where(hit, d2, carry[0]), torch.where(hit, obj, carry[1])

    m = q.shape[0]
    want = jq.traverse_nearest_stack(
        jb, jnp.asarray(q), jnp.arange(m, dtype=jnp.int32), jpush, jleaf,
        (jnp.float32(jnp.inf), jnp.int32(-1)))
    got = tq.traverse_nearest_stack(
        tb, torch.from_numpy(q), torch.arange(m, dtype=torch.int32), tpush,
        tleaf, (torch.tensor(float("inf")), torch.tensor(-1, dtype=torch.int32)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL)


def test_knn_plain_buffer_and_pops():
    """The plain KNN keeps (-1, inf) in slots no leaf fills (k = n), pops
    each node at most once, and gives equal distances in slot order."""
    pts = np.repeat(_cloud(seed=71, n=50), 2, axis=0)
    _, tb = _trees(pts)
    tp = torch.from_numpy(pts)
    idx, dist, pops = kn.nearest_knn_plain(tb, tp, 100, with_pops=True)
    assert (idx >= 0).all() and torch.isfinite(dist).all()
    assert (pops <= 2 * 100 - 1).all()
    # Each point's twin is its other zero-distance neighbour.
    assert torch.equal(dist[:, 1], torch.zeros(100))
    assert set(idx[0, :2].tolist()) == {0, 1}
    assert torch.equal(torch.sort(idx, 1).values,
                       torch.arange(100, dtype=torch.int32).expand(100, 100))


def test_wrappers_check_the_tree_height():
    pts = _cloud(seed=72, n=64)
    _, tb = _trees(pts)
    tp = torch.from_numpy(pts)
    h = kn.check_height(tb)
    assert 6 <= h < kn.STACK_DEPTH
    with pytest.raises(ValueError, match="96"):
        kn.nearest_knn(tb, tp, 2, height=kn.STACK_DEPTH)
    with pytest.raises(ValueError, match="96"):
        kn.nearest_ray(tb, tp, tp, height=kn.STACK_DEPTH)
    idx, _ = kn.nearest_knn(tb, tp, 2, height=h)
    assert torch.equal(idx[:, 0], torch.arange(64, dtype=torch.int32))
