"""The port's cell grid (``core/cell_grid.py``) and ``seg_min_per_point``
on the CPU against the JAX reference: every integer field exactly, the
cell boxes to 1 ulp (XLA:CPU may contract the reference's ``origin +
coord * size`` into a fused multiply-add, ROADMAP C8), and the linear ids
in int64 where the reference's int32 ids wrap (ROADMAP C9)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import cell_grid as jcg  # noqa: E402
from repro.core.dbscan import seg_min_per_point as jax_seg_min  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.core import cell_grid as tcg  # noqa: E402
from repro_torch.core.dbscan import seg_min_per_point  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.interop import cell_grid_from_numpy  # noqa: E402


def _grids(pts, size):
    jp = jnp.asarray(pts)
    jlo, jhi = jax_scene_bounds(jp)
    want = jcg.build_cell_grid(jp, jlo, jhi, jnp.float32(size))
    tp = torch.from_numpy(pts)
    got = tcg.build_cell_grid(tp, *scene_bounds(tp), float(np.float32(size)))
    return got, want


CASES = [(400, 0.05), (400, 0.05 / math.sqrt(3)), (1000, 0.01), (300, 0.3), (64, 2.0)]


@pytest.mark.parametrize("n,size", CASES)
def test_build_cell_grid_matches_reference(n, size):
    pts = make_clustered_points(np.random.default_rng(n), n)
    got, want = _grids(pts, size)
    for f in ("dims", "perm", "inv_perm", "cell_coord_sorted", "run_start", "run_length"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert got.cell_id_sorted.dtype == torch.int64
    np.testing.assert_array_equal(got.cell_id_sorted.numpy(),
                                  np.asarray(want.cell_id_sorted).astype(np.int64))
    for f in ("cell_size", "origin"):
        np.testing.assert_array_equal(getattr(got, f).numpy().view(np.int32),
                                      np.asarray(getattr(want, f)).view(np.int32))
    np.testing.assert_array_equal(got.dense_mask_sorted(3).numpy(),
                                  np.asarray(want.dense_mask_sorted(3)))
    np.testing.assert_array_equal(got.is_run_head().numpy(), np.asarray(want.is_run_head()))
    assert got.num_points == n


def _ulps(a, b):
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("n,size", CASES)
def test_cell_box_within_one_ulp(n, size):
    pts = make_clustered_points(np.random.default_rng(n + 1), n)
    got, want = _grids(pts, size)
    glo, ghi = tcg.cell_box(got, got.cell_coord_sorted)
    wlo, whi = jcg.cell_box(want, want.cell_coord_sorted)
    for g, w in ((glo, wlo), (ghi, whi)):
        assert int(_ulps(g.numpy(), np.asarray(w)).max()) <= 1


def test_linear_ids_do_not_wrap_past_2_31_cells():
    """ROADMAP C9: 1733^3 cells of 1e-3/sqrt(3); the cells (1, 1, 1) and
    (1431, 153, 611) have int32 ids that collide (they differ by exactly
    2^32), so the reference makes one run of two cells 0.9 apart. The
    port's int64 ids keep them apart."""
    base = np.array([[0, 0, 0], [1, 1, 1]], np.float32)
    lo = np.asarray(jax_scene_bounds(jnp.asarray(base))[0], np.float64)
    size = np.float32(1e-3) / np.float32(np.sqrt(3))
    cells = np.array([[1.5] * 3, [1431.5, 153.5, 611.5]])
    pts = np.concatenate([base, (lo + cells * size).astype(np.float32)])
    got, want = _grids(pts, size)
    np.testing.assert_array_equal(got.dims.numpy(), [1733] * 3)
    wid = np.asarray(want.cell_id_sorted)
    wlen = np.asarray(want.run_length)
    assert wid[1] == wid[2] and wlen[1] == 2          # the reference wraps
    gid = got.cell_id_sorted.numpy()
    assert gid[2] - gid[1] == 2 ** 32 and (got.run_length.numpy() == 1).all()


@pytest.mark.parametrize("size,max_dim_cells", [
    (1e-7, 1 << 30),   # 1.7e7 cells a side: 5e21 ids, past int64
    (0.01, 100),       # 174 cells a side, past the dimension limit
])
def test_grid_past_its_limits_raises(size, max_dim_cells):
    """ROADMAP C9: where the linear ids would pass int64, or a dimension
    would be clamped (cells past the clamp merged), the grid raises rather
    than let cells far apart share a run."""
    pts = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75]], dtype=torch.float32)
    size = float(np.float32(size) / np.float32(np.sqrt(3)))
    with pytest.raises(ValueError, match="C9"):
        tcg.build_cell_grid(pts, *scene_bounds(pts), size, max_dim_cells)
    # At the limits themselves the grid is built.
    lo, hi = scene_bounds(pts)
    dims = tcg.build_cell_grid(pts, lo, hi, 0.0625).dims
    top = int(dims.max())
    assert tcg.build_cell_grid(pts, lo, hi, 0.0625, top).dims.tolist() == dims.tolist()


def test_cell_grid_from_numpy():
    pts = make_clustered_points(np.random.default_rng(5), 200)
    got, want = _grids(pts, 0.04)
    conv = cell_grid_from_numpy(*(np.asarray(f) for f in want))
    for f in got._fields:
        g, c = getattr(got, f), getattr(conv, f)
        assert g.dtype == c.dtype, f
        np.testing.assert_array_equal(g.numpy(), c.numpy(), err_msg=f)


@pytest.mark.parametrize("n,runs,dtype", [(1, 1, np.int32), (50, 7, np.int32),
                                          (500, 120, np.int32), (500, 500, np.int32)])
def test_seg_min_per_point_exact(n, runs, dtype):
    rng = np.random.default_rng(n + runs)
    heads = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False)) if runs > 1 else []
    start = np.zeros(n, np.int32)
    for h in heads:
        start[h:] = h
    end = np.full(n, n, np.int32)
    for a, b in zip([0, *heads], [*heads, n]):
        end[a:b] = b
    length = (end - start).astype(np.int32)
    values = rng.integers(-1000, 1000, n).astype(dtype)
    want = np.asarray(jax_seg_min(jnp.asarray(values), jnp.asarray(start), jnp.asarray(length)))
    got = seg_min_per_point(torch.from_numpy(values), torch.from_numpy(start),
                            torch.from_numpy(length))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
