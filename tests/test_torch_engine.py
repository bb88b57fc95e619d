"""The port's generic engine (``query`` with callbacks, ``traverse``,
``node_reduce``), the ``core/traversal.py`` shims and the geometric tests
under XLA:CPU's flush of subnormals, on the CPU against the JAX reference
on the tree JAX built. Callbacks take lane batches in the port and one
query in the reference; both compute the same function."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import traversal as jtrav  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.bvh import build_bvh_objects as jax_build_bvh_objects  # noqa: E402
from repro.core.geometry import aabb_aabb_dist2 as jax_aabb_aabb_dist2  # noqa: E402
from repro.core.geometry import aabb_union as jax_aabb_union  # noqa: E402
from repro.core.geometry import point_aabb_dist2 as jax_point_aabb_dist2  # noqa: E402
from repro.core.geometry import Aabb as JaxAabb  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.core import geometry as tg  # noqa: E402
from repro_torch.core import traversal as ttrav  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")

N = 200
EPS = 0.05


def _cloud(seed=41, n=N):
    return make_clustered_points(np.random.default_rng(seed), n)


def _trees(pts, boxes=False):
    jp = jnp.asarray(pts)
    lo, hi = jax_scene_bounds(jp)
    if boxes:
        h = jnp.asarray(np.random.default_rng(42).uniform(
            0, 0.02, pts.shape).astype(np.float32))
        jb = jax_build_bvh_objects(jp - h, jp + h, lo, hi)
    else:
        jb = jax_build_bvh(jp, lo, hi)
    return jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, rtol=None):
    """Equal leaves, floats bit for bit (or within ``rtol``)."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = _np(g), np.asarray(w)
        if g.dtype == np.float32 and rtol is not None:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
            continue
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def _index_sum(xp):
    """The quickstart's callback: the sum of the hit objects' indices,
    and the sum of the values (d² or a ray's t) in visit order."""
    def cb(acc, qi, j, v):
        return (acc[0] + j, acc[1] + v), (False if xp is torch
                                          else jnp.bool_(False))
    return cb


def _preds(kind, pts):
    rng = np.random.default_rng(43)
    if kind == "within":
        return (jq.within(jnp.asarray(pts), EPS),
                tq.within(torch.from_numpy(pts), EPS))
    if kind == "box":
        c = rng.uniform(0, 1, (64, 3)).astype(np.float32)
        h = rng.uniform(0, 0.1, (64, 3)).astype(np.float32)
        return (jq.intersects_box(jnp.asarray(c - h), jnp.asarray(c + h)),
                tq.intersects_box(torch.from_numpy(c - h), torch.from_numpy(c + h)))
    o = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d[::3, 1:] = 0.0
    return (jq.ray(jnp.asarray(o), jnp.asarray(d)),
            tq.ray(torch.from_numpy(o), torch.from_numpy(d)))


@pytest.mark.parametrize("kind", ["within", "box", "ray"])
@pytest.mark.parametrize("backend", ["stackless", "stack"])
def test_query_callback_matches_reference(kind, backend):
    """Index sums exact, and t sums (rays) and d² sums (boxes: zeros) to
    the bit, on a box-leaf tree. XLA:CPU contracts the reference's sphere
    d² into fused multiply-adds (ROADMAP C8), the port never does, so the
    sphere's d² sums agree within 1e-6, a few ulp of each term."""
    pts = _cloud()
    jb, tb = _trees(pts, boxes=True)
    jp, tp = _preds(kind, pts)
    want = jq.query(jb, jp, _index_sum(jnp), (jnp.int32(0), jnp.float32(0)),
                    backend=backend)
    got = tq.query(tb, tp, _index_sum(torch),
                   (torch.tensor(0, dtype=torch.int32), torch.tensor(0.0)),
                   backend=backend, sort_queries=True)
    _eq(got, want, rtol=1e-6 if kind == "within" else None)
    assert int(got[0].sum()) > 0


def test_query_early_exit_stats_and_start_nodes():
    """A callback whose ``done`` is a lane tensor (stop at the first hit
    with an odd index), with stats, from random start nodes."""
    pts = _cloud(seed=44)
    jb, tb = _trees(pts)
    jp, tp = _preds("within", pts)
    start = np.random.default_rng(45).integers(-1, 2 * N - 1, N).astype(np.int32)
    start[start < 0] = -1

    def jcb(c, qi, j, d2):
        return c + 1, (j % 2) == 1

    def tcb(c, qi, j, d2):
        return c + 1, (j % 2) == 1

    for kwargs in ({}, {"start_nodes": start}):
        want, wst = jq.query(jb, jp, jcb, jnp.int32(0), with_stats=True,
                             **{k: jnp.asarray(v) for k, v in kwargs.items()})
        got, gst = tq.query(tb, tp, tcb, torch.tensor(0, dtype=torch.int32),
                            with_stats=True,
                            **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        _eq(got, want)
        _eq(tuple(gst), tuple(wst))
        assert bool(gst.early_exits.any())


def test_query_pallas_backend_matches_reference_kernel():
    pts = _cloud(seed=46, n=150)
    jb, tb = _trees(pts)
    jp, tp = _preds("ray", pts)

    def jcb(c, qi, j, t):
        return c + j, jnp.bool_(False)

    want = jq.query(jb, jp, jcb, jnp.int32(0), backend="pallas")
    got = tq.query(tb, tp, lambda c, qi, j, t: (c + j, False),
                   torch.tensor(0, dtype=torch.int32), backend="pallas")
    _eq(got, want)


def test_query_raises_what_is_not_ported():
    """The protocols' refusals (``Nearest`` and the nearest-hit ``Ray``,
    once refused here, are held against JAX in ``test_torch_nearest.py``
    and ``test_torch_raycast.py``)."""
    pts = _cloud(seed=47, n=40)
    _, tb = _trees(pts)
    tp = torch.from_numpy(pts)
    with pytest.raises(ValueError, match="per-query"):
        tq.query_count(tb, tq.within(tp, EPS), backend="pair")
    with pytest.raises(ValueError, match="start_nodes"):
        tq.query_count(tb, tq.within(tp, EPS), backend="stack",
                       start_nodes=torch.zeros(40, dtype=torch.int32))


@pytest.mark.parametrize("backend", ["stackless", "stack"])
def test_traverse_with_carry_pruning_matches_reference(backend):
    """A node test that reads the carry: prune once a query has seen 4
    leaves within 2 eps; the leaf callback counts and stops at 6."""
    pts = _cloud(seed=48)
    jb, tb = _trees(pts)
    r2 = np.float32(2 * EPS) ** 2

    def jnode(q, carry, node):
        d2 = jax_point_aabb_dist2(q[0], jb.node_lo[node], jb.node_hi[node])
        return (d2 <= r2) & (carry[1] < 4)

    def jleaf(q, carry, obj, k):
        d2 = jax_point_aabb_dist2(q[0], jb.node_lo[k + N - 1], jb.node_hi[k + N - 1])
        hit = d2 <= r2
        return (carry[0] + obj, carry[1] + hit.astype(jnp.int32)), carry[1] >= 6

    def tnode(q, carry, node):
        d2 = tg.point_aabb_dist2(q[0], tb.node_lo[node], tb.node_hi[node])
        return (d2 <= r2) & (carry[1] < 4)

    def tleaf(q, carry, obj, k):
        leaf = k.long() + N - 1
        hit = tg.point_aabb_dist2(q[0], tb.node_lo[leaf], tb.node_hi[leaf]) <= r2
        return (carry[0] + obj, carry[1] + hit.int()), carry[1] >= 6

    for with_stats in (False, True):
        want = jq.traverse(jb, (jnp.asarray(pts),), jnode, jleaf,
                           (jnp.int32(0), jnp.int32(0)), backend=backend,
                           with_stats=with_stats)
        got = tq.traverse(tb, (torch.from_numpy(pts),), tnode, tleaf,
                          (torch.tensor(0, dtype=torch.int32),
                           torch.tensor(0, dtype=torch.int32)),
                          backend=backend, with_stats=with_stats)
        _eq(got, want)


@pytest.mark.parametrize("boxes", [False, True])
def test_node_reduce_rebuilds_the_boxes(boxes):
    """Min/max of the leaf boxes, reduced bottom-up, are the tree's node
    boxes, in the port and in the reference; a count reduction too."""
    pts = _cloud(seed=49)
    jb, tb = _trees(pts, boxes=boxes)
    n = N
    inf = np.float32(np.inf)

    def jcomb(a, b):
        return (jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1]), a[2] + b[2])

    def tcomb(a, b):
        return (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]), a[2] + b[2])

    jl = (jb.node_lo[n - 1:], jb.node_hi[n - 1:], jnp.ones(n, jnp.int32))
    tl = (tb.node_lo[n - 1:], tb.node_hi[n - 1:], torch.ones(n, dtype=torch.int32))
    ident = (np.full(3, inf), np.full(3, -inf), np.int32(0))
    want = jq.node_reduce(jb, jl, jcomb,
                          tuple(jnp.asarray(x) for x in ident))
    got = tq.node_reduce(tb, tl, tcomb,
                         tuple(torch.from_numpy(np.asarray(x)) for x in ident))
    _eq(got, want)
    assert torch.equal(got[0], tb.node_lo) and torch.equal(got[1], tb.node_hi)
    assert int(got[2][0]) == n


def test_shims_match_reference():
    pts = _cloud(seed=50)
    jb, tb = _trees(pts)
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    radii = np.random.default_rng(51).uniform(0, 2 * EPS, N).astype(np.float32)

    def jleaf(c, obj, k):
        return c + obj, jnp.bool_(False)

    def tleaf(c, obj, k):
        return c + obj, False

    z32 = torch.tensor(0, dtype=torch.int32)
    for eps in (EPS, radii):
        je = jnp.asarray(eps)
        te = torch.as_tensor(eps)
        _eq(ttrav.traverse_sphere_stackless(tb, tp, te, tleaf, z32),
            jtrav.traverse_sphere_stackless(jb, jp, je, jleaf, jnp.int32(0)))
        _eq(ttrav.traverse_sphere_stack(tb, tp, te, tleaf, z32),
            jtrav.traverse_sphere_stack(jb, jp, je, jleaf, jnp.int32(0)))

    def jpair(c, i, j):
        d2 = jnp.sum((jp[i] - jp[j]) ** 2)
        return c + (d2 <= EPS ** 2).astype(jnp.int32), jnp.bool_(False)

    def tpair(c, i, j):
        d = tp[i.long()] - tp[j.long()]
        return c + ((d * d).sum(1) <= EPS ** 2).int(), False

    _eq(ttrav.pair_traverse_sphere(tb, tp, EPS, tpair, z32),
        jtrav.pair_traverse_sphere(jb, jp, EPS, jpair, jnp.int32(0)))


# --- XLA:CPU's flush of subnormals (ROADMAP C7) ------------------------------

def _origin_tree():
    pts = np.array([[0, 0, 0], [0.5, 0.5, 0.5], [1, 1, 1]], np.float32)
    return pts, _trees(pts)


def test_subnormal_distance_flushes_at_eps_zero():
    """At eps = 0, a query 1e-20 from a point: d² = 1e-40 is subnormal,
    which XLA:CPU flushes to 0, a hit."""
    pts, (jb, tb) = _origin_tree()
    q = np.array([[1e-20, 0, 0], [0, 0, 0], [2e-19, 0, 0]], np.float32)
    want = np.asarray(jq.query_count(jb, jq.within(jnp.asarray(q), 0.0)))
    got = tq.query_count(tb, tq.within(torch.from_numpy(q), 0.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 1, 0]
    d2 = tg.point_aabb_dist2(torch.from_numpy(q), torch.zeros(3, 3),
                             torch.zeros(3, 3))
    np.testing.assert_array_equal(
        d2.numpy(), np.asarray(jax_point_aabb_dist2(jnp.asarray(q), 0.0, 0.0)))


def test_subnormal_box_gap_flushes():
    """A box 1e-20 from a point: the gap's square flushes to 0, so
    ``IntersectsBox`` hits, as the reference's ``aabb_aabb_dist2 <= 0``."""
    pts, (jb, tb) = _origin_tree()
    lo = np.array([[1e-20, 0, 0], [-1, -1, 1e-20], [3e-19, 0, 0]], np.float32)
    hi = np.array([[1e-3, 1e-3, 1e-3], [1e-3, 1e-3, 1e-3],
                   [3e-19 + 1e-3, 1e-3, 1e-3]], np.float32)
    want = np.asarray(jq.query_count(
        jb, jq.intersects_box(jnp.asarray(lo), jnp.asarray(hi))))
    got = tq.query_count(tb, tq.intersects_box(torch.from_numpy(lo),
                                               torch.from_numpy(hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 1, 0]
    zero = np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(
        tg.aabb_aabb_dist2(torch.from_numpy(lo), torch.from_numpy(hi),
                           torch.from_numpy(zero), torch.from_numpy(zero)).numpy(),
        np.asarray(jax_aabb_aabb_dist2(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(zero), jnp.asarray(zero))))


def test_ray_nan_and_subnormal_inverse_match_reference():
    """A direction component in (-1e-12, 0) gives inverse +inf; a ray whose
    origin lies on that face gets 0 * inf = NaN, a miss in the reference
    (``(nan, False)``), while ``fminf``-style mins would report a hit.
    Subnormal directions read as 0, and subnormal inverses flush."""
    rng = np.random.default_rng(52)
    vals = np.concatenate([
        rng.standard_normal(4000).astype(np.float32)
        * (10.0 ** rng.integers(-44, 38, 4000)).astype(np.float32),
        np.array([0, -0.0, 1e-40, -1e-40, -5e-13, 5e-13, 1e-12, -1e-12,
                  3e38, -3e38], np.float32)]).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jq._safe_inv))(jnp.asarray(vals)))
    got = tg.safe_inv(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    o = np.array([[0.5, 0.25, 0.0], [0.5, 0.25, 0.0]], np.float32)
    d = np.array([[0.0, -5e-13, 1.0], [0.0, 0.0, 1.0]], np.float32)
    lo = np.array([[0.4, 0.25, 0.1]] * 2, np.float32)
    hi = np.array([[0.6, 0.3, 0.2]] * 2, np.float32)
    jt, jh = jax.vmap(jq._ray_box)(jnp.asarray(o), jax.vmap(jq._safe_inv)(
        jnp.asarray(d)), jnp.asarray(lo), jnp.asarray(hi))
    tt, th = tg.ray_box(torch.from_numpy(o), tg.safe_inv(torch.from_numpy(d)),
                        torch.from_numpy(lo), torch.from_numpy(hi))
    assert th.tolist() == np.asarray(jh).tolist() == [False, True]
    assert np.isnan(tt[0].item()) and np.isnan(np.asarray(jt)[0])
    assert tt[1].item() == np.asarray(jt)[1]


def test_ray_t_matches_reference_bits():
    """Random rays and boxes, origins on faces, axis-aligned and
    tiny-negative components: hits equal, and every hit's t bit-equal
    (+0, never -0)."""
    rng = np.random.default_rng(53)
    m = 20000
    o = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    d = rng.standard_normal((m, 3)).astype(np.float32)
    d[rng.random((m, 3)) < 0.2] = 0.0
    neg = rng.random((m, 3)) < 0.1
    d[neg] = -rng.uniform(0, 1e-12, neg.sum()).astype(np.float32)
    c = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    h = rng.uniform(0, 0.3, (m, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    on = rng.random((m, 3)) < 0.2
    lo[on] = o[on]
    jt, jh = jax.jit(jax.vmap(jq._ray_box))(
        jnp.asarray(o), jax.vmap(jq._safe_inv)(jnp.asarray(d)),
        jnp.asarray(lo), jnp.asarray(hi))
    tt, th = tg.ray_box(torch.from_numpy(o), tg.safe_inv(torch.from_numpy(d)),
                        torch.from_numpy(lo), torch.from_numpy(hi))
    jh = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tt.numpy()[jh].view(np.int32),
                                  np.asarray(jt)[jh].view(np.int32))
    assert 0.05 < jh.mean() < 0.95


def test_aabb_helpers_match_reference():
    rng = np.random.default_rng(54)
    a = rng.standard_normal((50, 3)).astype(np.float32)
    b = rng.standard_normal((50, 3)).astype(np.float32)
    a[:10], b[:10] = 0.0, -0.0
    want = jax_aabb_union(JaxAabb(jnp.asarray(a), jnp.asarray(a)),
                          JaxAabb(jnp.asarray(b), jnp.asarray(b)))
    got = tg.aabb_union(tg.Aabb(torch.from_numpy(a), torch.from_numpy(a)),
                        tg.Aabb(torch.from_numpy(b), torch.from_numpy(b)))
    _eq(tuple(got), tuple(want))
    box = tg.aabb_of_points(torch.from_numpy(a))
    np.testing.assert_array_equal(box.lo.numpy(), a.min(0))
    np.testing.assert_array_equal(box.hi.numpy(), a.max(0))
