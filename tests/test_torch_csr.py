"""The port's neighbor-list protocols (``query_fixed``, ``query_csr_device``,
``query_csr``, ``query_csr_buffered``) and ``query_count(sort_queries=)``
on the CPU against the JAX reference, on the tree JAX built: offsets,
indices in order, totals, overflow flags, buffers, counts and ``attempts``
must be equal. The JAX side runs its stackless core and its Pallas kernels
in interpret mode."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")

BACKENDS = ["stackless", "pallas"]
EPS = 0.05


def _tree(pts):
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    return jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


def _cloud(n=200, seed=0):
    return make_clustered_points(np.random.default_rng(seed), n)


def _skewed(n=128, nq=64):
    """One fat query covering the whole unit cube, the rest far away (the
    layout of ``tests/test_device_csr.py``)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    queries = np.full((nq, 3), 50.0, np.float32)
    queries[0] = 0.5
    radii = np.full((nq,), 1e-3, np.float32)
    radii[0] = 2.0
    return pts, queries, radii


def _preds(centers, radii):
    return (jq.within(jnp.asarray(centers), jnp.asarray(radii)),
            tq.within(torch.from_numpy(np.asarray(centers)),
                      torch.from_numpy(np.asarray(radii, np.float32))))


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, bool)):
            assert g == w, f
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


@pytest.mark.parametrize("backend", BACKENDS)
def test_csr_exact_equals_reference_for_every_chunk(backend):
    """The reference fills in chunk rounds; the port in one traversal. Each
    chunk gives the reference the same output, and the port that output."""
    pts = _cloud()
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    got = tq.query_csr(tb, tp)
    assert not bool(got.overflowed) and int(got.total) > 2 * len(pts)
    for chunk in (1, 3, 32):
        _assert_same(got, jq.query_csr(jb, jp, chunk=chunk, backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sort_queries", [False, True])
def test_csr_device_truncates_to_the_prefix(backend, sort_queries):
    pts = _cloud(seed=1)
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    exact = tq.query_csr(tb, tp)
    cap = int(exact.total) // 2
    want = jq.query_csr_device(jb, jp, cap, chunk=3, backend=backend,
                               sort_queries=sort_queries)
    got = tq.query_csr_device(tb, tp, cap, sort_queries=sort_queries)
    _assert_same(got, want)
    assert bool(got.overflowed)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  exact.indices[:cap].numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_csr_skewed_and_per_query_radii(backend):
    """A fat query that hits every point among queries that hit none, and
    a radius per query."""
    pts, queries, radii = _skewed()
    jb, tb = _tree(pts)
    jp, tp = _preds(queries, radii)
    for cap in (len(pts) + 8, 10, 0):
        _assert_same(tq.query_csr_device(tb, tp, cap),
                     jq.query_csr_device(jb, jp, cap, backend=backend))
    rng = np.random.default_rng(4)
    centers = rng.uniform(-0.1, 1.1, (70, 3)).astype(np.float32)
    radii = rng.uniform(0.0, 0.15, 70).astype(np.float32)
    jp, tp = _preds(centers, radii)
    _assert_same(tq.query_csr(tb, tp), jq.query_csr(jb, jp, backend=backend))


@pytest.mark.parametrize("capacity", [4, 0])
def test_csr_device_reuses_counts_and_ignores_chunk(capacity):
    pts = _cloud(seed=2)
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    counts = tq.query_count(tb, tp)
    want = jq.query_csr_device(jb, jp, capacity, counts=jnp.asarray(counts.numpy()))
    for chunk in (1, 32):
        _assert_same(tq.query_csr_device(tb, tp, capacity, counts=counts,
                                         chunk=chunk), want)


def test_csr_int64_offsets_match_reference_under_x64():
    pts = _cloud(seed=3)
    jb, tb = _tree(pts)
    tp = tq.within(torch.from_numpy(pts), EPS)
    got = tq.query_csr_device(tb, tp, 300, index_dtype=torch.int64)
    assert got.offsets.dtype == torch.int64 and got.total.dtype == torch.int64
    with jax.enable_x64(True):
        want = jq.query_csr_device(jb, jq.within(jnp.asarray(pts), EPS), 300,
                                   index_dtype=jnp.int64)
        assert want.offsets.dtype == jnp.int64
        _assert_same(got, want)
    narrow = tq.query_csr_device(tb, tp, 300)
    np.testing.assert_array_equal(got.offsets.numpy(), narrow.offsets.numpy())
    np.testing.assert_array_equal(got.indices.numpy(), narrow.indices.numpy())


def test_csr_empty_predicate_set():
    pts = _cloud(n=16, seed=4)
    jb, tb = _tree(pts)
    jp, tp = _preds(np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    _assert_same(tq.query_csr(tb, tp), jq.query_csr(jb, jp))
    _assert_same(tq.query_csr_device(tb, tp, 4),
                 jq.query_csr_device(jb, jp, 4))
    _assert_same(tq.query_csr_buffered(tb, tp, capacity=2),
                 jq.query_csr_buffered(jb, jp, capacity=2))
    buf, counts, over = tq.query_fixed(tb, tp, 3)
    assert buf.shape == (0, 3) and counts.shape == (0,) and not bool(over)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("capacity", [1, 2, 64])
def test_buffered_attempts_equal_reference(backend, capacity):
    pts = _cloud(seed=5)
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    got = tq.query_csr_buffered(tb, tp, capacity=capacity)
    _assert_same(got, jq.query_csr_buffered(jb, jp, capacity=capacity,
                                            backend=backend))
    exact = tq.query_csr(tb, tp)
    np.testing.assert_array_equal(got.offsets.numpy(), exact.offsets.numpy())
    np.testing.assert_array_equal(got.indices.numpy(), exact.indices.numpy())
    assert (got.attempts > 1) == (capacity < int(np.diff(exact.offsets.numpy()).max()))


def test_buffered_raises_after_max_doublings():
    pts = _cloud(seed=6)
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    with pytest.raises(RuntimeError, match="at capacity 8") as want:
        jq.query_csr_buffered(jb, jp, capacity=1, max_doublings=2)
    with pytest.raises(RuntimeError) as got:
        tq.query_csr_buffered(tb, tp, capacity=1, max_doublings=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sort_queries", [False, True])
def test_fixed_overwrites_the_last_slot(backend, sort_queries):
    pts = _cloud(seed=7)
    jb, tb = _tree(pts)
    jp, tp = _preds(pts, np.full(len(pts), EPS, np.float32))
    buf, counts, over = tq.query_fixed(tb, tp, 4, sort_queries=sort_queries)
    want = jq.query_fixed(jb, jp, 4, backend=backend, sort_queries=sort_queries)
    for g, w in zip((buf, counts, over), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Rows that overflowed end with their last hit in traversal order.
    exact = tq.query_csr(tb, tp)
    offs = exact.offsets.numpy()
    full = np.nonzero(counts.numpy() > 4)[0]
    assert bool(over) and full.size
    np.testing.assert_array_equal(buf.numpy()[full, 3],
                                  exact.indices.numpy()[offs[full + 1] - 1])


@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
def test_compact_csr_equals_reference_on_overflowed_rows(index_dtype):
    """Rows whose count exceeds the buffer keep their ``cap`` slots and
    leave -1 where the surplus hits would go, as the reference's scatter
    does."""
    rng = np.random.default_rng(14)
    counts = np.array([0, 3, 7, 1, 4, 0, 9], np.int32)
    buf = rng.integers(0, 100, (len(counts), 4)).astype(np.int32)
    buf[np.arange(4)[None, :] >= counts[:, None]] = -1
    got = tq._compact_csr(torch.from_numpy(buf), torch.from_numpy(counts),
                          getattr(torch, index_dtype))
    with jax.enable_x64(index_dtype == "int64"):
        want = jq._compact_csr(jnp.asarray(buf), jnp.asarray(counts),
                               getattr(jnp, index_dtype))
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, str(w.dtype))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() == -1).sum() == (3 + 5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_count_sort_queries_changes_no_result(backend):
    pts = _cloud(seed=8)
    jb, tb = _tree(pts)
    centers = np.random.default_rng(9).uniform(-0.2, 1.2, (150, 3)).astype(np.float32)
    jp, tp = _preds(centers, np.full(150, 0.08, np.float32))
    want = jq.query_count(jb, jp, stop_at=3, backend=backend, sort_queries=True)
    for sort_queries in (False, True):
        got = tq.query_count(tb, tp, stop_at=3, sort_queries=sort_queries)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_permutation_equals_reference():
    pts = _cloud(seed=10)
    jb, tb = _tree(pts)
    centers = np.random.default_rng(11).uniform(-0.3, 1.3, (257, 3)).astype(np.float32)
    centers[:40] = pts[:40]
    want = jq.query_sort_permutation(jb, jnp.asarray(centers))
    got = tq.query_sort_permutation(tb, torch.from_numpy(centers))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_protocols_reject_what_is_not_ported():
    pts = _cloud(n=32, seed=12)
    _, tb = _tree(pts)
    tp = tq.within(torch.from_numpy(pts), EPS)
    box = (torch.zeros(2, 3), torch.ones(2, 3))
    for call in (lambda: tq.query_csr(tb, box),
                 lambda: tq.query_fixed(tb, box, 4),
                 lambda: tq.query_csr_buffered(tb, box),
                 lambda: tq.query_count(tb, box)):
        with pytest.raises(TypeError, match="Within"):
            call()
    with pytest.raises(ValueError, match="index_dtype"):
        tq.query_csr_device(tb, tp, 8, index_dtype=torch.int16)
    with pytest.raises(ValueError, match="not both"):
        tq.query_csr(tb, tp, sort_queries=True, order=tb.leaf_perm)


def test_cpu_protocols_launch_no_kernel(monkeypatch):
    wrappers = (kw.wavefront_count, kw.wavefront_fill, kw.wavefront_fixed)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    pts = _cloud(n=64, seed=13)
    _, tb = _tree(pts)
    tp = tq.within(torch.from_numpy(pts), EPS)
    tq.query_csr(tb, tp)
    tq.query_csr_buffered(tb, tp, capacity=2)
    assert [fn.launches for fn in wrappers] == [0, 0, 0]
