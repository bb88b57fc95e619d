"""The port's traversal (plain version of the wavefront kernel) against the
JAX reference's stackless core and its Pallas kernel in interpret mode, on
the tree JAX built, carried over by ``interop.bvh_from_numpy``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.dbscan import min_core_label_on as jax_min_core_label_on  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.query import query as jax_query  # noqa: E402
from repro.core.query import query_count as jax_query_count  # noqa: E402
from repro.core.query import within as jax_within  # noqa: E402
from repro_torch.core.dbscan import min_core_label_on  # noqa: E402
from repro_torch.core.query import query_count, within  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402

BACKENDS = ["stackless", "pallas"]
EPS = 0.06


def _trees(n=300, seed=0):
    pts = make_clustered_points(np.random.default_rng(seed), n)
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    tb = bvh_from_numpy(*(np.asarray(f) for f in jb))
    return pts, jb, tb


def _queries(q, seed):
    return np.random.default_rng(seed).uniform(0, 1, (q, 3)).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("stop_at", [None, 2, 5])
def test_count_matches_reference(backend, stop_at):
    pts, jb, tb = _trees()
    want = jax_query_count(jb, jax_within(jnp.asarray(pts), EPS),
                           stop_at=stop_at, backend=backend)
    got = query_count(tb, within(torch.from_numpy(pts), EPS), stop_at=stop_at,
                      order=tb.leaf_perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("q", [1, 127, 130])
def test_count_query_counts_off_the_block(backend, q):
    """Query counts that are not multiples of the reference's 128-lane
    block or of the kernel's thread block."""
    _, jb, tb = _trees(seed=1)
    centers = _queries(q, q)
    want = jax_query_count(jb, jax_within(jnp.asarray(centers), EPS),
                           stop_at=3, backend=backend)
    got = query_count(tb, within(torch.from_numpy(centers), EPS), stop_at=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_min_label(jb, pts, labels, core, mask, sentinel, backend):
    if backend == "stackless":
        return np.asarray(jax_min_core_label_on(
            jb, jnp.asarray(pts), EPS, jnp.asarray(labels), jnp.asarray(core),
            jnp.asarray(mask), sentinel))
    # A Pallas kernel body may not capture arrays, so the callback cannot
    # read labels[j] and core[j]. The tree's leaf_perm is only the object
    # id handed to the callback: give it core objects' labels (sentinel for
    # the rest) and the callback's min over "object ids" is the min label.
    perm = np.asarray(jb.leaf_perm)
    relabelled = jb._replace(leaf_perm=jnp.asarray(
        np.where(core[perm], labels[perm], sentinel).astype(np.int32)))
    out = jax_query(relabelled, jax_within(jnp.asarray(pts), jnp.float32(EPS)),
                    lambda best, _qi, j, _d2: (jnp.minimum(best, j),
                                               jnp.bool_(False)),
                    jnp.int32(sentinel), backend="pallas")
    return np.where(mask, np.asarray(out), sentinel)


@pytest.mark.parametrize("backend", BACKENDS)
def test_min_label_matches_reference(backend):
    pts, jb, tb = _trees(seed=2)
    n = len(pts)
    rng = np.random.default_rng(3)
    labels = rng.permutation(n).astype(np.int32)
    core = rng.random(n) < 0.6
    mask = rng.random(n) < 0.7
    want = _jax_min_label(jb, pts, labels, core, mask, n, backend)
    got = min_core_label_on(tb, torch.from_numpy(pts), EPS,
                            torch.from_numpy(labels), torch.from_numpy(core),
                            torch.from_numpy(mask), n, order=tb.leaf_perm)
    np.testing.assert_array_equal(got.numpy(), want)
