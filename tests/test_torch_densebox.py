"""``fdbscan_densebox`` and the traversal's DENSE_COUNT and
DENSE_MIN_LABEL epilogues on the CPU against the JAX reference: labels,
core mask and rounds exactly, in the reference's regimes
(``tests/test_dbscan.py``), on 32-bit codes, on coincident points, and
where the reference's int32 cell ids wrap (ROADMAP C9): there the port
equals ``fdbscan``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.dbscan import fdbscan_densebox as jax_densebox  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.data.pipeline import hacc_benchmark_epsilon  # noqa: E402
from repro_torch.core.dbscan import densebox_tree, fdbscan, fdbscan_densebox  # noqa: E402
from repro_torch.core.geometry import sum_sq  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402


def _same(got, want):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_densebox_random_regime(seed):
    """The reference's property regime: 150 clustered points, eps 0.07,
    min_pts 5."""
    pts = make_clustered_points(np.random.default_rng(seed), 150)
    _same(fdbscan_densebox(pts, 0.07, 5, device="cpu"),
          jax_densebox(jnp.asarray(pts), 0.07, 5))


@pytest.mark.parametrize("seed", [0, 1])
def test_densebox_benchmark_regime(seed):
    """The HACC linking length at 512 points, min_pts 2 (the regime whose
    regression the reference's union from every core point fixed); the
    labels are also fdbscan's."""
    pts = make_clustered_points(np.random.default_rng(seed), 512)
    eps = hacc_benchmark_epsilon(1.0, 512)
    got = fdbscan_densebox(pts, eps, 2, device="cpu")
    _same(got, jax_densebox(jnp.asarray(pts), eps, 2))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  fdbscan(pts, eps, 2, device="cpu").labels.numpy())


@pytest.mark.parametrize("eps,min_pts", [(0.03, 2), (0.05, 5), (0.1, 20), (0.02, 3)])
@pytest.mark.parametrize("use_64bit", [True, False])
def test_densebox_exact_against_reference(eps, min_pts, use_64bit):
    pts = make_clustered_points(np.random.default_rng(int(eps * 1000) + min_pts), 600)
    _same(fdbscan_densebox(pts, eps, min_pts, use_64bit, device="cpu"),
          jax_densebox(jnp.asarray(pts), eps, min_pts, use_64bit=use_64bit))


def test_densebox_coincident_points():
    pts = np.zeros((30, 3), np.float32) + 0.5
    pts[15:] += 0.4
    _same(fdbscan_densebox(pts, 0.01, 2, device="cpu"),
          jax_densebox(jnp.asarray(pts), 0.01, 2))


def test_densebox_equals_fdbscan_where_the_reference_wraps():
    """ROADMAP C9: four points on a grid of 1733^3 cells; the reference's
    DenseBox joins the two cell centres 0.9 apart (labels [-1, -1, 2, 2])
    because their int32 cell ids collide. The port's ids are int64, so it
    gives fdbscan's all-noise labels."""
    base = np.array([[0, 0, 0], [1, 1, 1]], np.float32)
    lo = np.asarray(jax_scene_bounds(jnp.asarray(base))[0], np.float64)
    size = np.float32(1e-3) / np.float32(np.sqrt(3))
    cells = np.array([[1.5] * 3, [1431.5, 153.5, 611.5]])
    pts = np.concatenate([base, (lo + cells * size).astype(np.float32)])
    wrapped = np.asarray(jax_densebox(jnp.asarray(pts), 1e-3, 2).labels)
    np.testing.assert_array_equal(wrapped, [-1, -1, 2, 2])
    got = fdbscan_densebox(pts, 1e-3, 2, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), [-1] * 4)
    _same(got, jax_fdbscan(jnp.asarray(pts), 1e-3, 2))


@pytest.mark.parametrize("eps,min_pts", [(0.03, 2), (0.06, 5)])
def test_dense_count_is_the_eps_count_of_loose_points(eps, min_pts):
    """Without early exit DENSE_COUNT counts, for each loose point, every
    point within eps: cells wholesale or point by point, points by their
    test, skipped leaves through their cell. Against a brute-force count
    with the same float32 formula; ``tally`` sees whole and scanned cells."""
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(9), 800))
    t = densebox_tree(pts, eps, min_pts)
    tally = {}
    counts = kw.wavefront_dense_count(t.bvh, t.pts_sorted, t.r2,
                                      t.words(torch.zeros(800, dtype=torch.int32)),
                                      t.pts_sorted, t.half, qmask=~t.dense)
    kw.wavefront_dense_count_plain(t.bvh, t.pts_sorted, t.r2,
                                   t.words(torch.zeros(800, dtype=torch.int32)),
                                   t.pts_sorted, t.half, None, ~t.dense, tally)
    loose = torch.nonzero(~t.dense).flatten()
    for q in loose.tolist():
        d2 = sum_sq(t.pts_sorted - t.pts_sorted[q])
        assert int(counts[q]) == int((d2 <= t.r2[q]).sum()), q
    assert int(counts[t.dense].abs().sum()) == 0
    assert tally["whole"] > 0 and tally["scanned"] > 0


def test_dense_wrappers_take_box_leaf_trees_only():
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(2), 100))
    t = densebox_tree(pts, 0.05, 3)
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    point_tree = build_bvh(pts, *scene_bounds(pts))
    words = t.words(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError, match="box"):
        kw.wavefront_dense_count(point_tree, t.pts_sorted, t.r2, words, t.pts_sorted, t.half)
    with pytest.raises(ValueError, match="points"):
        kw.wavefront_edge(t.bvh, t.pts_sorted, t.r2,
                          torch.zeros((100, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="points"):
        kw.wavefront_histogram(t.bvh, t.pts_sorted, t.r2, 0.1, 4)
    with pytest.raises(ValueError, match="words"):
        kw.wavefront_dense_count(t.bvh, t.pts_sorted, t.r2, words[:5], t.pts_sorted,
                                 t.half)


@pytest.mark.parametrize("side", ["keys", "words", "pts", "scan_lab", "qmask"])
def test_side_tensors_must_be_on_the_queries_device(side):
    """A side tensor on another device than the queries raises ValueError
    (on the card a host pointer would otherwise reach the kernel); a meta
    tensor stands in for the other device."""
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(3), 100))
    t = densebox_tree(pts, 0.05, 3)
    args = {"keys": torch.zeros((100, 2), dtype=torch.int32),
            "words": t.words(torch.zeros(100, dtype=torch.int32)),
            "pts": t.pts_sorted, "scan_lab": torch.zeros(100, dtype=torch.int32),
            "qmask": torch.ones(100, dtype=torch.bool)}
    args[side] = args[side].to("meta")
    with pytest.raises(ValueError, match="device"):
        if side == "keys":
            from repro_torch.core.bvh import build_bvh
            from repro_torch.core.geometry import scene_bounds
            tree = build_bvh(pts, *scene_bounds(pts))
            kw.wavefront_edge(tree, t.pts_sorted, t.r2, args["keys"], 2)
        else:
            kw.wavefront_dense_min_label(t.bvh, t.pts_sorted, t.r2, args["words"],
                                         args["pts"], args["scan_lab"], t.half,
                                         args["qmask"], 100)
