"""The port's FDBSCAN and adjacency-graph DBSCAN on the CPU against the JAX
reference, exactly, and FDBSCAN's partition against the numpy oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.dbscan import dbscan_graph_cc as jax_dbscan_graph_cc  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.ref_numpy import dbscan_ref  # noqa: E402
from repro_torch.core.dbscan import dbscan_graph_cc, fdbscan  # noqa: E402

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
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(NotImplementedError, match="A8"):
        fdbscan(pts, EPS, 2, device="cpu", **kwargs)


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
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(NotImplementedError, match="A8"):
        dbscan_graph_cc(pts, EPS, 2, use_64bit=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dbscan_graph_cc(pts, EPS, 2)
