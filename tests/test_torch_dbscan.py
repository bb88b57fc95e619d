"""The port's FDBSCAN and adjacency-graph DBSCAN on the CPU against the JAX
reference, exactly, and FDBSCAN's partition against the numpy oracle; with
the stack backend and the 32-bit build too, and ``count_neighbors`` and
``min_core_label_on`` called the reference's way."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.dbscan import count_neighbors as jax_count_neighbors  # noqa: E402
from repro.core.dbscan import dbscan_graph_cc as jax_dbscan_graph_cc  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.dbscan import min_core_label_on as jax_min_core_label_on  # noqa: E402
from repro.core.ref_numpy import dbscan_ref  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.dbscan import (count_neighbors, dbscan_graph_cc,  # noqa: E402
                                     fdbscan, min_core_label_on)

EPS = 0.03


def _same_partition(a, b):
    """Equal noise sets and a bijection between cluster labels."""
    np.testing.assert_array_equal(a < 0, b < 0)
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    assert len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_pts", [2, 5])
def test_fdbscan_exact_against_reference(seed, min_pts):
    pts = make_clustered_points(np.random.default_rng(seed), 600)
    want = jax_fdbscan(jnp.asarray(pts), EPS, min_pts)
    got = fdbscan(pts, EPS, min_pts, device="cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    _same_partition(got.labels.numpy(), dbscan_ref(pts, EPS, min_pts))


def test_fdbscan_without_early_stop():
    pts = make_clustered_points(np.random.default_rng(5), 300)
    want = jax_fdbscan(jnp.asarray(pts), EPS, 3, early_stop=False)
    got = fdbscan(pts, EPS, 3, early_stop=False, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("kwargs", [{"use_stack": True}, {"use_64bit": False}])
def test_unported_options_raise(kwargs):
    """The options that raised naming A8 until the stack backend and the
    32-bit build were ported, now exact against the reference (with and
    without early exit)."""
    pts = make_clustered_points(np.random.default_rng(11), 400)
    for early_stop in (True, False):
        want = jax_fdbscan(jnp.asarray(pts), EPS, 3, early_stop=early_stop,
                           **kwargs)
        got = fdbscan(pts, EPS, 3, early_stop=early_stop, device="cpu",
                      **kwargs)
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} {early_stop}")


@pytest.mark.parametrize("eps,min_pts,capacity", [
    (0.03, 2, 64), (0.03, 5, 64),
    # Neighbourhoods past the capacity: the documented drawback, where
    # surplus neighbours overwrite the last slot, reproduced exactly.
    (0.05, 2, 8), (0.05, 5, 4)])
def test_dbscan_graph_cc_exact_against_reference(eps, min_pts, capacity):
    pts = make_clustered_points(np.random.default_rng(7), 500)
    want = jax_dbscan_graph_cc(jnp.asarray(pts), eps, min_pts,
                               neighbor_capacity=capacity)
    got = dbscan_graph_cc(pts, eps, min_pts, capacity, device="cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("eps,min_pts", [(0.02, 2), (0.05, 2), (0.03, 5)])
def test_dbscan_graph_cc_equals_fdbscan_with_enough_capacity(eps, min_pts):
    pts = make_clustered_points(np.random.default_rng(8), 2000)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    largest = int((d2 <= np.float32(eps) ** 2).sum(1).max())
    capacity = 1 << (largest - 1).bit_length()  # no buffer overflows
    ref = fdbscan(pts, eps, min_pts, device="cpu")
    got = dbscan_graph_cc(pts, eps, min_pts, capacity, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), ref.labels.numpy())
    np.testing.assert_array_equal(got.core_mask.numpy(), ref.core_mask.numpy())


def test_dbscan_graph_cc_unported_option_and_no_card(monkeypatch):
    """``use_64bit=False`` (which raised naming A8) against the reference;
    without a card the default device raises."""
    pts = make_clustered_points(np.random.default_rng(12), 400)
    want = jax_dbscan_graph_cc(jnp.asarray(pts), EPS, 2, neighbor_capacity=16,
                               use_64bit=False)
    got = dbscan_graph_cc(pts, EPS, 2, 16, use_64bit=False, device="cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dbscan_graph_cc(pts[:4], EPS, 2)


def _both_trees(pts):
    jp = jnp.asarray(pts)
    lo, hi = jp.min(0) - 1e-4, jp.max(0) + 1e-4
    tp = torch.from_numpy(pts)
    return jp, jax_build_bvh(jp, lo, hi), tp, build_bvh(
        tp, torch.from_numpy(np.asarray(lo)), torch.from_numpy(np.asarray(hi)))


@pytest.mark.parametrize("use_stack", [False, True])
def test_count_neighbors_the_reference_way(use_stack):
    """``count_neighbors(bvh, points, queries, eps, min_pts, use_stack)``
    positionally, as ``tests/test_dbscan.py:113`` calls the reference."""
    pts = make_clustered_points(np.random.default_rng(13), 200)
    jp, jb, tp, tb = _both_trees(pts)
    for min_pts in (None, 5):
        want = np.asarray(jax_count_neighbors(jb, jp, jp, 0.05, min_pts,
                                              use_stack))
        got = count_neighbors(tb, tp, tp, 0.05, min_pts, use_stack)
        np.testing.assert_array_equal(got.numpy(), want)
    full = count_neighbors(tb, tp, tp, 0.05)
    sat = count_neighbors(tb, tp, tp, 0.05, min_pts=5)
    assert bool((sat <= torch.clamp(full, max=5)).all())


def test_min_core_label_on_int64_labels():
    """Labels keep their dtype, as the reference's (here under x64): int64
    labels inside the int32 range and past 2^32 (the sharded path's
    global ids at scale) give the reference's int64 result through the
    kernel's int64 instance; a sentinel outside int32 raises for int32
    labels instead of wrapping."""
    pts = make_clustered_points(np.random.default_rng(14), 300)
    n = len(pts)
    rng = np.random.default_rng(15)
    labels = rng.permutation(n).astype(np.int64)
    core = rng.random(n) < 0.6
    mask = rng.random(n) < 0.8
    jp, jb, tp, tb = _both_trees(pts)
    for offset in (0, 2**32, 2**40 + 7):
        with jax.enable_x64(True):
            want = np.asarray(jax_min_core_label_on(
                jb, jp, EPS, jnp.asarray(labels + offset), jnp.asarray(core),
                jnp.asarray(mask), n + offset))
        assert want.dtype == np.int64
        got = min_core_label_on(tb, tp, EPS, torch.from_numpy(labels + offset),
                                torch.from_numpy(core), torch.from_numpy(mask),
                                n + offset)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(offset))
        if offset:
            assert (want > 2**32).all()
    with pytest.raises(ValueError, match="sentinel"):
        min_core_label_on(tb, tp, EPS, torch.from_numpy(labels.astype(np.int32)),
                          torch.from_numpy(core), torch.from_numpy(mask),
                          2**33)