"""The port's traversal counters (``query_count(with_stats=True)``,
``TraversalStats``), start nodes and node depth table on the CPU against
the JAX reference's ``stackless`` core and its Pallas kernel in interpret
mode: every column exact."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.query import query_count as jax_query_count  # noqa: E402
from repro.core.query import within as jax_within  # noqa: E402
from repro_torch.core.bvh import SENTINEL, build_bvh  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.core.query import node_depths, query_count, within  # noqa: E402
from repro_torch.obs import TraversalStats  # noqa: E402

jq = importlib.import_module("repro.core.query")

BACKENDS = ["stackless", "pallas"]
EPS = 0.05


def _trees(kind="clustered", n=400, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        pts = make_clustered_points(rng, n)
    elif kind == "n2":
        pts = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    else:   # coincident points: zero-size boxes that tie
        base = rng.uniform(0, 1, (n // 8, 3)).astype(np.float32)
        pts = np.repeat(base, 8, axis=0)[rng.permutation(n // 8 * 8)]
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    return pts, jax_build_bvh(jp, *jax_scene_bounds(jp)), build_bvh(tp, *scene_bounds(tp))


def _assert_stats_equal(jax_stats, stats):
    assert isinstance(stats, TraversalStats)
    for f in TraversalStats._fields:
        got, want = getattr(stats, f), np.asarray(getattr(jax_stats, f))
        assert got.dtype == (torch.bool if f == "early_exits" else torch.int32), f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("kind", ["clustered", "n2", "coincident"])
def test_node_depths_match_reference(kind):
    _, jb, tb = _trees(kind)
    got = node_depths(tb)
    assert got.dtype == torch.int32 and got.shape == (2 * tb.num_leaves - 1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._node_depths(jb)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("stop_at", [None, 3])
@pytest.mark.parametrize("sort_queries", [False, True])
def test_count_stats_match_reference(backend, stop_at, sort_queries):
    pts, jb, tb = _trees()
    want, want_stats = jax_query_count(
        jb, jax_within(jnp.asarray(pts), EPS), stop_at=stop_at,
        backend=backend, sort_queries=sort_queries, with_stats=True)
    got, stats = query_count(tb, within(torch.from_numpy(pts), EPS),
                             stop_at=stop_at, sort_queries=sort_queries,
                             with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats_equal(want_stats, stats)
    # The counts are the stats-off counts, and every walk that hit stop_at
    # ended on it.
    torch.testing.assert_close(
        got, query_count(tb, within(torch.from_numpy(pts), EPS),
                         stop_at=stop_at), rtol=0, atol=0)
    if stop_at is not None:
        assert bool(stats.early_exits.any())
        assert torch.equal(stats.early_exits, got >= stop_at)


@pytest.mark.parametrize("backend", BACKENDS)
def test_count_stats_with_radius_per_query(backend):
    pts, jb, tb = _trees(seed=3)
    rng = np.random.default_rng(4)
    centers = rng.uniform(-0.1, 1.1, (90, 3)).astype(np.float32)
    radii = rng.uniform(0, 0.3, 90).astype(np.float32)
    want, want_stats = jax_query_count(
        jb, jax_within(jnp.asarray(centers), jnp.asarray(radii)),
        backend=backend, with_stats=True)
    got, stats = query_count(
        tb, within(torch.from_numpy(centers), torch.from_numpy(radii)),
        with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats_equal(want_stats, stats)


def _starts(n_nodes, q, case, seed):
    rng = np.random.default_rng(seed)
    if case == "all_sentinel":
        return np.full(q, SENTINEL, np.int32)
    starts = rng.integers(0, n_nodes, q).astype(np.int32)
    if case == "mixed":
        starts[rng.random(q) < 0.25] = SENTINEL
    return starts


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["nodes", "mixed", "all_sentinel"])
@pytest.mark.parametrize("stop_at", [None, 2])
def test_start_nodes_match_reference(backend, case, stop_at):
    pts, jb, tb = _trees(seed=5)
    starts = _starts(2 * len(pts) - 1, len(pts), case, len(case))
    want, want_stats = jax_query_count(
        jb, jax_within(jnp.asarray(pts), EPS), stop_at=stop_at,
        backend=backend, with_stats=True, start_nodes=jnp.asarray(starts))
    got, stats = query_count(tb, within(torch.from_numpy(pts), EPS),
                             stop_at=stop_at, with_stats=True,
                             start_nodes=torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats_equal(want_stats, stats)
    idle = torch.from_numpy(starts == SENTINEL)
    assert bool((got[idle] == 0).all())
    for f in TraversalStats._fields:
        assert not bool(getattr(stats, f)[idle].any()), f
    plain = query_count(tb, within(torch.from_numpy(pts), EPS),
                        stop_at=stop_at, start_nodes=torch.from_numpy(starts))
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_start_nodes_with_sorted_queries_match_reference():
    """With ``sort_queries`` the reference permutes the start nodes with
    the queries; the port's start node stays with its query."""
    pts, jb, tb = _trees(seed=6)
    starts = _starts(2 * len(pts) - 1, len(pts), "mixed", 6)
    want, want_stats = jax_query_count(
        jb, jax_within(jnp.asarray(pts), EPS), backend="stackless",
        sort_queries=True, with_stats=True, start_nodes=jnp.asarray(starts))
    got, stats = query_count(tb, within(torch.from_numpy(pts), EPS),
                             sort_queries=True, with_stats=True,
                             start_nodes=torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats_equal(want_stats, stats)


@pytest.mark.parametrize("stop_at", [None, 2])
def test_totals_match_reference(stop_at):
    pts, jb, tb = _trees(seed=7)
    _, want = jax_query_count(jb, jax_within(jnp.asarray(pts), EPS),
                              stop_at=stop_at, with_stats=True)
    _, stats = query_count(tb, within(torch.from_numpy(pts), EPS),
                           stop_at=stop_at, with_stats=True)
    want_t, got_t = want.totals(), stats.totals()
    assert set(got_t) == set(want_t)
    for k, v in got_t.items():
        assert v.shape == () and v.dtype == torch.int32, k
        assert int(v) == int(want_t[k]), k


def test_totals_of_no_queries():
    empty = torch.zeros(0, dtype=torch.int32)
    stats = TraversalStats(empty, empty, empty, empty,
                           torch.zeros(0, dtype=torch.bool), empty)
    assert {k: int(v) for k, v in stats.totals().items()} == dict.fromkeys(
        TraversalStats._fields, 0)


def test_stats_rows_round_trip():
    rows = torch.arange(24, dtype=torch.int32).view(6, 4) % 2
    stats = TraversalStats.from_rows(rows)
    assert stats.early_exits.dtype == torch.bool
    for i, f in enumerate(TraversalStats._fields):
        np.testing.assert_array_equal(getattr(stats, f).int().numpy(),
                                      rows[i].numpy())
