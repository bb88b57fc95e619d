"""``IntersectsBox`` and the all-hits ``Ray`` on every output protocol, on
point trees (``build_bvh``) and box-leaf trees (``build_bvh_objects``), on
the CPU against the JAX reference on the tree JAX built: counts, buffers,
CSR offsets and indices in order, totals and attempts exactly equal. The
JAX side runs its stackless core, and its Pallas kernels in interpret mode
where noted; the port runs the plain version of its kernel and its stack
backend."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.bvh import build_bvh_objects as jax_build_bvh_objects  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")

N, Q = 256, 96
TREES = ["points", "boxes"]
PREDS = ["box", "ray"]


def _points():
    return make_clustered_points(np.random.default_rng(31), N)


def _half_widths():
    return np.random.default_rng(32).uniform(0, 0.03, (N, 3)).astype(np.float32)


_CACHE = {}


def _tree(kind):
    """(JAX tree, port tree carried over from it)."""
    if kind not in _CACHE:
        pts = jnp.asarray(_points())
        lo, hi = jax_scene_bounds(pts)
        if kind == "points":
            jb = jax_build_bvh(pts, lo, hi)
        else:
            h = jnp.asarray(_half_widths())
            jb = jax_build_bvh_objects(pts - h, pts + h, lo, hi)
        _CACHE[kind] = (jb, bvh_from_numpy(*(np.asarray(f) for f in jb)))
    return _CACHE[kind]


def box_queries(seed=33):
    """Boxes of half-width up to 0.12 anywhere in the cloud, and degenerate
    boxes [p, p] at points of the cloud."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.05, 1.05, (Q, 3)).astype(np.float32)
    h = rng.uniform(0, 0.12, (Q, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    at = _points()[rng.integers(0, N, Q // 4)]
    lo[: Q // 4], hi[: Q // 4] = at, at
    return lo, hi


def ray_queries(seed=34):
    """Rays from the low-z face and from points of the cloud; a quarter
    along an axis exactly (two zero components), some with a component in
    (-1e-12, 0) (inverse +inf)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0, 1, (Q, 3)).astype(np.float32)
    o[:, 2] = -0.01
    o[1::3] = _points()[rng.integers(0, N, len(o[1::3]))]
    d = rng.standard_normal((Q, 3)).astype(np.float32)
    d[::4, :2] = 0.0
    d[::4, 2] = 1.0
    d[2::9, 0] = -rng.uniform(0, 1e-12, len(d[2::9])).astype(np.float32)
    return o, d


def preds(kind):
    if kind == "box":
        lo, hi = box_queries()
        return (jq.intersects_box(jnp.asarray(lo), jnp.asarray(hi)),
                tq.intersects_box(torch.from_numpy(lo), torch.from_numpy(hi)))
    o, d = ray_queries()
    return (jq.ray(jnp.asarray(o), jnp.asarray(d)),
            tq.ray(torch.from_numpy(o), torch.from_numpy(d)))


def _same(got, want):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, bool)):
            assert g == w, f
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("backend", ["stackless", "stack"])
def test_count_and_fixed_match_reference(tree, pred, backend):
    jb, tb = _tree(tree)
    jp, tp = preds(pred)
    for stop_at in (None, 3):
        want = np.asarray(jq.query_count(jb, jp, stop_at=stop_at,
                                         backend=backend))
        got = tq.query_count(tb, tp, stop_at=stop_at, backend=backend,
                             sort_queries=backend == "stackless")
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > Q // 4
    for cap in (2, 64):
        wb, wc, wo = jq.query_fixed(jb, jp, cap, backend=backend)
        gb, gc, go = tq.query_fixed(tb, tp, cap, backend=backend)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        assert bool(go) == bool(wo)


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("backend", ["stackless", "stack"])
def test_csr_protocols_match_reference(tree, pred, backend):
    jb, tb = _tree(tree)
    jp, tp = preds(pred)
    exact = tq.query_csr(tb, tp, backend=backend)
    _same(exact, jq.query_csr(jb, jp, backend=backend))
    half = int(exact.total) // 2
    _same(tq.query_csr_device(tb, tp, half, backend=backend),
          jq.query_csr_device(jb, jp, half, backend=backend))
    _same(tq.query_csr_buffered(tb, tp, capacity=2, backend=backend),
          jq.query_csr_buffered(jb, jp, capacity=2, backend=backend))


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("pred", PREDS)
def test_pallas_backend_matches_reference_kernel(tree, pred):
    """``backend="pallas"`` is the port's stackless path; it equals the
    reference's Pallas kernels (interpret mode) on counts and CSR."""
    jb, tb = _tree(tree)
    jp, tp = preds(pred)
    np.testing.assert_array_equal(
        tq.query_count(tb, tp, backend="pallas").numpy(),
        np.asarray(jq.query_count(jb, jp, backend="pallas")))
    _same(tq.query_csr(tb, tp, backend="pallas"),
          jq.query_csr(jb, jp, backend="pallas", chunk=8))


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("pred", PREDS)
def test_counters_and_start_nodes_match_reference(tree, pred):
    jb, tb = _tree(tree)
    jp, tp = preds(pred)
    rng = np.random.default_rng(35)
    start = rng.integers(0, 2 * N - 1, Q).astype(np.int32)
    start[rng.random(Q) < 0.25] = -1
    for kwargs in ({}, {"start_nodes": start}):
        want, wst = jq.query_count(
            jb, jp, with_stats=True,
            **{k: jnp.asarray(v) for k, v in kwargs.items()})
        got, gst = tq.query_count(
            tb, tp, with_stats=True,
            **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for f in wst._fields:
            np.testing.assert_array_equal(getattr(gst, f).numpy(),
                                          np.asarray(getattr(wst, f)),
                                          err_msg=f)


def test_sphere_on_box_leaves_matches_reference():
    """``Within`` on a box-leaf tree: the leaf test is the point-box
    distance to the leaf's box, on every protocol."""
    jb, tb = _tree("boxes")
    pts = _points()
    jp = jq.within(jnp.asarray(pts), 0.02)
    tp = tq.within(torch.from_numpy(pts), 0.02)
    np.testing.assert_array_equal(tq.query_count(tb, tp).numpy(),
                                  np.asarray(jq.query_count(jb, jp)))
    _same(tq.query_csr(tb, tp, order=tb.leaf_perm), jq.query_csr(jb, jp))


def test_box_leaf_tree_is_never_packed_as_points():
    """The tree carried over from JAX knows its leaves are boxes, and its
    records hold lo and hi; packed as points (lo as both corners) it would
    count otherwise."""
    jb, tb = _tree("boxes")
    assert tb.box_leaves and not _tree("points")[1].box_leaves
    packed = kw.pack_tree(tb)
    n = tb.num_leaves
    assert packed.box_leaves and packed.leaves.shape == (n, 8)
    leaves = packed.leaves.view(torch.int32)
    assert torch.equal(leaves[:, :3], tb.node_lo[n - 1:].view(torch.int32))
    assert torch.equal(leaves[:, 4:7], tb.node_hi[n - 1:].view(torch.int32))
    assert torch.equal(leaves[:, 3], tb.rope[n - 1:])
    assert torch.equal(leaves[:, 7], tb.rope[n - 1:])
    _, tp = preds("box")
    qa, qb, kind = tq.query_geometry(tp)
    as_points = tb._replace(node_hi=torch.cat([tb.node_hi[:n - 1],
                                               tb.node_lo[n - 1:]]))
    right = kw.wavefront_count(tb, qa, qb, pred=kind)
    wrong = kw.wavefront_count(as_points, qa, qb, pred=kind)
    assert not torch.equal(right, wrong)
    # A tree that does not say reads its leaves: the same records.
    unknown = kw.pack_tree(tb._replace(box_leaves=None))
    assert torch.equal(unknown.leaves.view(torch.int32), leaves)


def test_min_label_and_potential_take_spheres_on_points():
    _, tb = _tree("boxes")
    pts = torch.from_numpy(_points())
    r2 = torch.full((N,), 0.02 ** 2)
    ones = torch.ones(N, dtype=torch.bool)
    labels = torch.arange(N, dtype=torch.int32)
    with pytest.raises(ValueError, match="B1 \\(d\\)"):
        kw.wavefront_min_label(tb, pts, r2, labels, ones, ones, N)
    with pytest.raises(ValueError, match="B1 \\(d\\)"):
        kw.wavefront_potential(tb, pts, r2, 1e-6)
    with pytest.raises(ValueError, match="pred must be"):
        kw.wavefront_count(tb, pts, r2, pred="nearest")
    with pytest.raises(ValueError, match="box queries"):
        kw.wavefront_count(tb, pts, r2, pred="box")
