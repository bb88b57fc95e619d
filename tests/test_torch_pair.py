"""The pair backend (``query(..., backend="pair")``), the traversal's EDGE
epilogue and ``fdbscan_pair``, on the CPU against the JAX reference on the
tree JAX built. Integer carries, stats, the EDGE capture buffer and DBSCAN's
labels, core mask and rounds are compared exactly; a sphere's d² within
1e-6 relative, since XLA:CPU contracts the reference's d² into fused
multiply-adds and the port does not (ROADMAP C8)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.dbscan import fdbscan_pair as jax_fdbscan_pair  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.data.pipeline import hacc_benchmark_epsilon  # noqa: E402
from repro_torch.core.dbscan import fdbscan, fdbscan_pair  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")

EPS = 0.05


def _setup(seed=51, n=300):
    pts = make_clustered_points(np.random.default_rng(seed), n)
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    return pts, jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _callbacks(xp):
    false = False if xp is torch else jnp.bool_(False)
    return {
        # Count and index sums: every pair once, in rope order.
        "count": (lambda c, i, j, d2: ((c[0] + 1, c[1] + i + 2 * j), false),
                  (0, 0)),
        # The least (partner, query) key: the query index handed to the
        # callback is the original leaf_perm[k].
        "min_partner": (lambda c, i, j, d2: (xp.minimum(c, j * 1000 + i), false),
                        10 ** 6),
        # Early exit at the third hit.
        "first3": (lambda c, i, j, d2: (c + 1, c + 1 >= 3), 0),
        # The squared distances handed to the callback.
        "d2": (lambda c, i, j, d2: (c + d2, false), 0.0),
    }


def _init(xp, v):
    if isinstance(v, tuple):
        return tuple(_init(xp, x) for x in v)
    if xp is torch:
        return torch.tensor(v, dtype=torch.float32 if isinstance(v, float) else torch.int32)
    return jnp.asarray(v, jnp.float32 if isinstance(v, float) else jnp.int32)


@pytest.mark.parametrize("name", ["count", "min_partner", "first3", "d2"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_pair_backend_matches_reference(name, with_stats):
    """Carries in sorted (Morton) order, row k for original point
    leaf_perm[k], and with stats the six counters, row for row."""
    pts, jb, tb = _setup()
    jcb, init = _callbacks(jnp)[name]
    tcb, _ = _callbacks(torch)[name]
    want = jq.query(jb, jq.within(jnp.asarray(pts), EPS), jcb, _init(jnp, init),
                    backend="pair", with_stats=with_stats)
    got = tq.query(tb, tq.within(torch.from_numpy(pts), EPS), tcb, _init(torch, init),
                   backend="pair", with_stats=with_stats)
    if with_stats:
        (want, wst), (got, gst) = want, got
        for g, w in zip(gst, wst):
            np.testing.assert_array_equal(_np(g), _np(w))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = _np(g), _np(w)
        if name == "d2":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_pair_backend_visits_each_unordered_pair_once():
    pts, _, tb = _setup(n=200)
    per_q = tq.query(tb, tq.within(torch.from_numpy(pts), EPS),
                     lambda c, i, j, d2: (c + 1, False), torch.tensor(0), backend="pair")
    full = tq.query_count(tb, tq.within(torch.from_numpy(pts), EPS))
    assert int(per_q.sum()) * 2 == int(full.sum()) - len(pts)


def test_pair_backend_raises_as_the_reference():
    pts, jb, tb = _setup(n=40)
    tp, jp = torch.from_numpy(pts), jnp.asarray(pts)

    def cb(c, i, j, d2):
        return c, False

    cases = [
        (TypeError, lambda q, p, z: q.query(
            tb if q is tq else jb, q.intersects_box(p, p), cb, z, backend="pair")),
        (ValueError, lambda q, p, z: q.query(
            tb if q is tq else jb, q.within(p[:30], EPS), cb, z, backend="pair")),
        (ValueError, lambda q, p, z: q.query(
            tb if q is tq else jb, q.within(p, EPS), cb, z, backend="pair",
            sort_queries=True)),
        (ValueError, lambda q, p, z: q.query(
            tb if q is tq else jb, q.ray(p, p), cb, z, backend="pair")),
        (ValueError, lambda q, p, z: q.query(
            tb if q is tq else jb, q.within(p, EPS), cb, z, backend="pair",
            start_nodes=(torch if q is tq else jnp).zeros(40, dtype=(
                torch.int32 if q is tq else jnp.int32)))),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call(jq, jp, jnp.int32(0))
        with pytest.raises(exc):
            call(tq, tp, torch.tensor(0))


def _jax_capture(jb, pts, parent, core, cap):
    """The reference's capture callback (repro/core/dbscan.py:239-252) on
    its pair backend: (buf, cnt) in sorted order."""
    jcore, jparent = jnp.asarray(core), jnp.asarray(parent)

    def fn(carry, i_orig, j_orig, _d2):
        buf, cnt = carry
        take = jcore[i_orig] & jcore[j_orig] & (jparent[i_orig] != jparent[j_orig])
        slot = jnp.clip(cnt, 0, cap - 1)
        buf = jnp.where(take, buf.at[slot].set(j_orig), buf)
        cnt = cnt + take.astype(jnp.int32)
        return (buf, cnt), cnt >= cap

    buf0 = jnp.full((cap,), -1, jnp.int32)
    return jq.query(jb, jq.within(jnp.asarray(pts), EPS), fn, (buf0, jnp.int32(0)),
                    backend="pair")


@pytest.mark.parametrize("capacity", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_capture_bit_equal_to_reference(capacity, seed):
    """The EDGE epilogue's plain version, buffer and counts bit for bit
    against the reference's capture for a given parent and core mask: the
    walk's order decides which edges fill a buffer."""
    pts, jb, tb = _setup(seed=60 + seed)
    n = len(pts)
    rng = np.random.default_rng(seed)
    core = rng.random(n) < 0.7
    parent = rng.integers(0, 30, n).astype(np.int32)
    wbuf, wcnt = _jax_capture(jb, pts, parent, core, capacity)
    perm = tb.leaf_perm.long()
    tp = torch.from_numpy(pts)
    keys = kw.pair_keys(tb, torch.from_numpy(parent), torch.from_numpy(core))
    r2 = tq.squared_radii(tq.within(tp, EPS))
    gbuf, gcnt = kw.wavefront_edge(tb, tp[perm].contiguous(), r2[perm].contiguous(),
                                   keys, capacity, start=kw.pair_starts(tb))
    np.testing.assert_array_equal(gbuf.numpy(), np.asarray(wbuf))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    assert int(gcnt.max()) == capacity


def _same(got, want):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("capacity", [1, 2, 8])
@pytest.mark.parametrize("seed,eps,min_pts", [(0, 0.03, 2), (1, 0.05, 5), (2, 0.08, 10)])
def test_fdbscan_pair_exact_against_reference(capacity, seed, eps, min_pts):
    pts = make_clustered_points(np.random.default_rng(seed), 500)
    want = jax_fdbscan_pair(jnp.asarray(pts), eps, min_pts, edge_capacity=capacity)
    got = fdbscan_pair(pts, eps, min_pts, edge_capacity=capacity, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("capacity", [1, 8])
def test_fdbscan_pair_32bit_and_benchmark_regime(capacity):
    """``use_64bit=False``, and the HACC linking length at 512 points (the
    reference's benchmark regime); the labels are also fdbscan's."""
    pts = make_clustered_points(np.random.default_rng(3), 512)
    eps = hacc_benchmark_epsilon(1.0, 512)
    for kwargs in ({"use_64bit": False}, {}):
        want = jax_fdbscan_pair(jnp.asarray(pts), eps, 2, edge_capacity=capacity, **kwargs)
        got = fdbscan_pair(pts, eps, 2, edge_capacity=capacity, device="cpu", **kwargs)
        _same(got, want)
    ref = fdbscan(pts, eps, 2, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), ref.labels.numpy())
    np.testing.assert_array_equal(np.asarray(jax_fdbscan(jnp.asarray(pts), eps, 2).labels),
                                  ref.labels.numpy())


def test_fdbscan_pair_rejects_an_empty_buffer_and_needs_a_card():
    pts = make_clustered_points(np.random.default_rng(4), 50)
    with pytest.raises(ValueError, match="edge_capacity"):
        fdbscan_pair(pts, EPS, 2, edge_capacity=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fdbscan_pair(pts, EPS, 2)
