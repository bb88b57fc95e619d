"""The port's grid DBSCAN (``core/fdbscan_grid.py``) on the CPU against the
JAX reference (Pallas kernels in interpret mode), exactly: the neighbour
map, the binning, labels, core mask, rounds and ``overflowed``.

Clustering inputs are tie-free at ε (``drop_ties``, the band stated in
``test_torch_pairwise.py``), because the grid's d² = ‖x‖² + ‖y‖² − 2x·y
agrees with XLA's only away from ties; on such inputs it also agrees with
the port's own ``fdbscan``, which computes Σ(x − y)² (ROADMAP C2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import fdbscan_grid as jgrid  # noqa: E402
from repro_torch.core import fdbscan_grid as tgrid  # noqa: E402
from repro_torch.core.dbscan import fdbscan  # noqa: E402
from repro_torch.kernels import pairwise as kp  # noqa: E402
from test_torch_pairwise import drop_ties  # noqa: E402

EPS = 0.22  # 5^3 grid over the unit box
LO = np.zeros(3, np.float32)
DIMS = (5, 5, 5)


def _assert_same(got, want):
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, (field, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("dims", [(3, 4, 5), (1, 1, 1), (1, 7, 2), (6, 6, 6)])
def test_stencil_neighbor_map_exact(dims):
    want = jgrid.stencil_neighbor_map(dims)
    got = tgrid.stencil_neighbor_map(dims, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stencil_neighbor_map_reach_and_2d():
    for dims, reach in (((3, 4, 5), 2), ((4, 6), 1), ((9,), 3)):
        np.testing.assert_array_equal(
            tgrid.stencil_neighbor_map(dims, reach, device="cpu").numpy(),
            jgrid.stencil_neighbor_map(dims, reach))


def test_grid_dims_for():
    for lo, hi, size in ((np.zeros(3), np.ones(3), EPS), (np.zeros(3), np.full(3, 0.61), 0.15),
                         ([-1.0, 0.0], [1.0, 0.3], 0.1), (np.zeros(3), np.ones(3), 2.0 ** -8)):
        assert tgrid.grid_dims_for(lo, hi, size) == jgrid.grid_dims_for(lo, hi, size)


def _lattice():
    """Points on cell edges: spacing 0.1 with eps = 0.15, so 0.3 and 0.6
    are exact float32 multiples of the cell size (the reference's
    ``tests/test_fdbscan_grid.py:70``)."""
    g = (np.arange(7) * 0.1).astype(np.float32)
    return np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("case", ["overflow", "lattice"])
def test_bin_points_exact(case):
    if case == "overflow":
        pts, size, dims, cap = make_clustered_points(np.random.default_rng(3), 300), EPS, DIMS, 2
    else:
        pts, size = _lattice(), 0.15
        dims, cap = jgrid.grid_dims_for(np.zeros(3), np.full(3, 0.61), size), 32
    want = jgrid.bin_points(jnp.asarray(pts), jnp.zeros(3, jnp.float32),
                            jnp.float32(size), dims, cap)
    got = tgrid.bin_points(torch.from_numpy(pts), LO, size, dims, cap)
    _assert_same(got, want)
    assert bool(got.overflowed) == (case == "overflow")
    assert got.num_cells == int(np.prod(dims))


def _clustered(seed, n=300):
    return drop_ties(make_clustered_points(np.random.default_rng(seed), n), EPS)


@pytest.mark.parametrize("min_pts", [2, 5, 10])
def test_fdbscan_grid_exact_against_reference(min_pts):
    pts = _clustered(3)
    want, want_ovf = jgrid.fdbscan_grid(jnp.asarray(pts), EPS, min_pts, scene_lo=LO,
                                        grid_dims=DIMS, capacity=128)
    for fn in (kp.stencil_count, kp.stencil_min_label):
        fn.launches = 0
    got, ovf = tgrid.fdbscan_grid(pts, EPS, min_pts, scene_lo=LO, grid_dims=DIMS,
                                  capacity=128, device="cpu")
    _assert_same(got, want)
    assert ovf.dtype == torch.bool and bool(ovf) == bool(want_ovf) is False
    assert kp.stencil_count.launches == kp.stencil_min_label.launches == 0
    # Tie-free, the grid's formula and fdbscan's Σ(x−y)² agree on every pair.
    ref = fdbscan(pts, EPS, min_pts, device="cpu")
    np.testing.assert_array_equal(got.core_mask.numpy(), ref.core_mask.numpy())
    np.testing.assert_array_equal(got.labels.numpy(), ref.labels.numpy())


def test_fdbscan_grid_overflow_and_lattice():
    pts = _clustered(5)
    want, want_ovf = jgrid.fdbscan_grid(jnp.asarray(pts), EPS, 3, scene_lo=LO,
                                        grid_dims=DIMS, capacity=16)
    got, ovf = tgrid.fdbscan_grid(pts, EPS, 3, scene_lo=LO, grid_dims=DIMS,
                                  capacity=16, device="cpu")
    assert bool(want_ovf) and bool(ovf)
    _assert_same(got, want)
    pts = _lattice()
    dims = jgrid.grid_dims_for(np.zeros(3), np.full(3, 0.61), 0.15)
    want, _ = jgrid.fdbscan_grid(jnp.asarray(pts), 0.15, 2, scene_lo=LO,
                                 grid_dims=dims, capacity=32)
    got, ovf = tgrid.fdbscan_grid(pts, 0.15, 2, scene_lo=LO, grid_dims=dims,
                                  capacity=32, device="cpu")
    assert not bool(ovf)
    _assert_same(got, want)


def test_fdbscan_grid_auto_exact_against_reference():
    pts = drop_ties(np.random.default_rng(8).uniform(0, 1, (300, 3)).astype(np.float32), EPS)
    kw = dict(scene_lo=LO, scene_hi=np.ones(3, np.float32), capacity=2, with_info=True)
    want, want_info = jgrid.fdbscan_grid_auto(jnp.asarray(pts), EPS, 4, **kw)
    got, info = tgrid.fdbscan_grid_auto(pts, EPS, 4, device="cpu", **kw)
    assert isinstance(info, tgrid.GridAutoInfo)
    assert tuple(info) == tuple(want_info) and info.attempts > 1
    _assert_same(got, want)
    with pytest.raises(RuntimeError, match="still overflows"):
        tgrid.fdbscan_grid_auto(pts, EPS, 4, scene_lo=LO, scene_hi=np.ones(3),
                                capacity=1, max_doublings=1, device="cpu")


def _forbid_allocation(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("allocated before the slot-space check")
    for name in ("full", "empty", "zeros", "ones", "arange", "tensor"):
        monkeypatch.setattr(torch, name, refuse)


def test_slot_space_guard_raises_before_any_allocation(monkeypatch):
    pts = np.zeros((4, 3), np.float32)
    dims = (1024, 1024, 1024)                    # (2^30 + 1) * 2 > 2^31 - 1
    _forbid_allocation(monkeypatch)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tgrid.fdbscan_grid(pts, 2.0 ** -10, 2, scene_lo=LO, grid_dims=dims,
                           capacity=2, device="cpu")
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tgrid.bin_points(pts, LO, 2.0 ** -10, dims, 2)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tgrid.fdbscan_grid_auto(pts, 2.0 ** -10, 2, scene_lo=LO,
                                scene_hi=np.ones(3), capacity=2, device="cpu")


def test_auto_raises_when_a_doubling_would_pass_int32(monkeypatch):
    """The first attempt fits the slot space and overflows; the doubled
    capacity would pass 2^31 - 1, and that attempt raises before binning
    allocates. The first binning is stood in for, to keep the test small."""
    dims = (1024, 1024, 1023)                    # (ncells + 1) * 2 fits
    real = tgrid.bin_points
    caps = []

    def first_overflows(points, scene_lo, cell_size, grid_dims, capacity):
        caps.append(capacity)
        if len(caps) == 1:
            return tgrid.CellBins(torch.empty((1, 1, 3)), torch.zeros(4, dtype=torch.int32),
                                  torch.tensor(True))
        _forbid_allocation(monkeypatch)
        return real(points, scene_lo, cell_size, grid_dims, capacity)

    monkeypatch.setattr(tgrid, "bin_points", first_overflows)
    monkeypatch.setattr(tgrid, "grid_dims_for", lambda lo, hi, size: dims)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tgrid.fdbscan_grid_auto(np.zeros((4, 3), np.float32), 2.0 ** -10, 2,
                                scene_lo=LO, scene_hi=np.ones(3), capacity=2,
                                device="cpu")
    assert caps == [2, 4]


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgrid.fdbscan_grid(pts, EPS, 2, scene_lo=LO, grid_dims=DIMS, capacity=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgrid.fdbscan_grid_auto(pts, EPS, 2, scene_lo=LO, scene_hi=np.ones(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgrid.stencil_neighbor_map(DIMS)
