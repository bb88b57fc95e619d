"""The port's Euclidean MST (``emst``: Borůvka rounds over the nearest walk
of another component) and its parts on the CPU against the JAX reference.

Edges are compared as a set of unordered pairs and rounds exactly; edge
weights within ``rtol=2e-6`` and the total within ``rtol=1e-5`` (XLA:CPU
contracts the reference's d² into fused multiply-adds, ROADMAP C8, and
sums the weights in another order). The clouds are drawn from fixed seeds
whose per-component least edges are not near-ties."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402

jemst = importlib.import_module("repro.core.emst")
temst = importlib.import_module("repro_torch.core.emst")


def _trees(pts):
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    return jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


def _pairs(edges):
    e = np.sort(np.asarray(edges), 1)
    return {tuple(p) for p in e.tolist()}


def _assert_emst(got, want, n):
    assert got.edges.shape == (n - 1, 2) and got.edges.dtype == torch.int32
    assert int(got.rounds) == int(want.rounds)
    assert _pairs(got.edges.numpy()) == _pairs(want.edges)
    # Weights by pair.
    wmap = {p: w for p, w in zip(map(tuple, np.sort(np.asarray(want.edges), 1)
                                     .tolist()), np.asarray(want.weights))}
    gw = np.array([wmap[p] for p in map(tuple, np.sort(got.edges.numpy(), 1)
                                        .tolist())])
    np.testing.assert_allclose(got.weights.numpy(), gw, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(float(got.total_weight), float(want.total_weight),
                               rtol=1e-5)


@pytest.mark.parametrize("kind,n,seed", [("clustered", 1000, 81),
                                         ("uniform", 700, 82),
                                         ("clustered", 2048, 83)])
def test_emst_matches_reference(kind, n, seed):
    rng = np.random.default_rng(seed)
    pts = (make_clustered_points(rng, n) if kind == "clustered"
           else rng.uniform(0, 1, (n, 3)).astype(np.float32))
    want = jemst.emst(jnp.asarray(pts))
    got = temst.emst(pts, device="cpu")
    _assert_emst(got, want, n)


def test_emst_two_coincident_points():
    pts = np.full((2, 3), 0.25, np.float32)
    want = jemst.emst(jnp.asarray(pts))
    got = temst.emst(pts, device="cpu")
    _assert_emst(got, want, 2)
    assert got.edges.tolist() == [[0, 1]] and float(got.weights[0]) == 0.0


def test_emst_spans_the_points():
    """n - 1 edges joining every point into one tree (no cycle)."""
    pts = np.random.default_rng(84).uniform(0, 1, (300, 3)).astype(np.float32)
    res = temst.emst(pts, device="cpu")
    parent = list(range(300))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in res.edges.tolist():
        ra, rb = find(a), find(b)
        assert ra != rb
        parent[ra] = rb
    assert len({find(i) for i in range(300)}) == 1


@pytest.mark.parametrize("n_comp", [1, 5, 700])
def test_node_component_intervals_match_reference(n_comp):
    pts = make_clustered_points(np.random.default_rng(85), 700)
    jb, tb = _trees(pts)
    comp = np.random.default_rng(86).integers(0, n_comp, 700).astype(np.int32)
    want = jemst._node_component_intervals(jb, jnp.asarray(comp)[jb.leaf_perm])
    got = temst._node_component_intervals(
        tb, torch.from_numpy(comp)[tb.leaf_perm.long()])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_comp", [1, 3, 40, 800])
def test_nearest_other_component_matches_reference(n_comp):
    """One round's walk; with one component no point has a neighbour
    (inf, -1)."""
    pts = make_clustered_points(np.random.default_rng(87), 800)
    jb, tb = _trees(pts)
    comp = np.random.default_rng(88).integers(0, n_comp, 800).astype(np.int32)
    jd2, jj = jemst._nearest_other_component(jb, jnp.asarray(pts),
                                             jnp.asarray(comp))
    d2, j = temst._nearest_other_component(tb, torch.from_numpy(pts),
                                           torch.from_numpy(comp))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=2e-6)
    if n_comp == 1:
        assert (j == -1).all() and torch.isinf(d2).all()


def test_emst_raises_where_tied_least_edges_close_a_cycle():
    """ROADMAP C11: on a lattice with many coincident points the
    reference's rule picks cycles and its result does not span; the
    port raises instead."""
    pts = (np.random.default_rng(0).integers(0, 4, (300, 3)) / 4).astype(np.float32)
    want = jemst.emst(jnp.asarray(pts))
    parent = list(range(300))

    def find(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for a, b in np.asarray(want.edges).tolist():
        parent[find(a)] = find(b)
    assert len({find(i) for i in range(300)}) > 1
    with pytest.raises(ValueError, match="C11"):
        temst.emst(pts, device="cpu")
