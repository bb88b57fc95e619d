"""``pair_count_histogram`` and ``two_point_correlation`` (the pair
traversal's HISTOGRAM epilogue) on the CPU against the JAX reference.

A pair's bin is ``floor(sqrt(d²) / r_max * n_bins)``: where a distance
lies within rounding of a bin edge, the reference's d² (contracted into
fused multiply-adds by XLA:CPU, ROADMAP C8) and the port's may fall on
either side. The inputs are therefore tie-free (:func:`drop_edge_ties`):
no pair lies within TIE_BAND (relative) of a bin edge or of r_max, far
wider than either formula's rounding (a few ulp, 1e-6 relative). On them
the counts are exact; ξ, computed from them in float64 the reference's
way, is compared exactly too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import correlation as jc  # noqa: E402
from repro_torch.core import correlation as tc  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

tq = __import__("importlib").import_module("repro_torch.core.query")

TIE_BAND = 1e-4


def drop_edge_ties(pts, r_max, n_bins):
    """The rows of ``pts``, in order, dropping each that makes a pair
    within TIE_BAND of a bin edge (r_max included) with a row kept."""
    dist = np.sqrt(((pts.astype(np.float64)[:, None] - pts[None]) ** 2).sum(-1))
    edges = np.arange(1, n_bins + 1) * (float(np.float32(r_max)) / n_bins)
    rel = np.abs(dist[..., None] / edges - 1.0).min(-1)
    near = rel < TIE_BAND
    np.fill_diagonal(near, False)
    keep = []
    for i in range(len(pts)):
        if not near[i, keep].any():
            keep.append(i)
    return pts[keep]


CASES = [(300, 0.1, 16), (300, 0.2, 1), (400, 0.05, 50), (250, 0.3, 7)]


@pytest.mark.parametrize("n,r_max,n_bins", CASES)
def test_pair_count_histogram_exact_on_tie_free_inputs(n, r_max, n_bins):
    pts = drop_edge_ties(make_clustered_points(np.random.default_rng(n + n_bins), n),
                         r_max, n_bins)
    want = np.asarray(jc.pair_count_histogram(jnp.asarray(pts), r_max, n_bins))
    got = tc.pair_count_histogram(pts, r_max, n_bins, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("n,r_max,n_bins", CASES[:2])
def test_two_point_correlation_matches_reference(n, r_max, n_bins):
    pts = drop_edge_ties(make_clustered_points(np.random.default_rng(n), n), r_max, n_bins)
    want = jc.two_point_correlation(jnp.asarray(pts), r_max, n_bins, volume=2.0)
    got = tc.two_point_correlation(pts, r_max, n_bins, volume=2.0, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_histogram_total_is_the_pair_count():
    """Every unordered pair within r_max once: the total is (the sum of the
    r_max counts, each point counting itself, minus n) / 2."""
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(8), 700))
    hist = tc.pair_count_histogram(pts, 0.15, 12, device="cpu")
    bvh = build_bvh(pts, *scene_bounds(pts))
    within = int(tq.query_count(bvh, tq.within(pts, 0.15)).sum())
    assert 2 * int(hist.sum()) == within - 700


def test_histogram_bins_match_the_reference_formula():
    """The bin of one squared distance, the reference's expression in JAX
    on the same float32 values: random ones, bin edges and their
    neighbours, subnormals, zero."""
    rng = np.random.default_rng(4)
    r_max, n_bins = np.float32(0.3), 16
    d = rng.random(100_000).astype(np.float32) * r_max
    edges = (np.arange(n_bins + 1, dtype=np.float32) * (r_max / np.float32(n_bins))) ** 2
    d2 = np.concatenate([d * d, edges, np.nextafter(edges, np.float32(1)),
                         np.nextafter(edges, np.float32(0)),
                         np.array([1e-40, 0.0, 1e-31, 1e-29], np.float32)])
    x = jnp.asarray(d2)
    b = jnp.floor(jnp.sqrt(jnp.maximum(x, 1e-30)) / jnp.asarray(r_max) * n_bins)
    want = np.asarray(jnp.clip(b.astype(jnp.int32), 0, n_bins - 1))
    got = kw.histogram_bins(torch.from_numpy(d2), float(r_max), n_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kw.histogram_bins_rn(torch.from_numpy(d2), float(r_max),
                                                       n_bins).numpy(), want)


def test_histogram_wrapper_checks():
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(1), 64))
    bvh = build_bvh(pts, *scene_bounds(pts))
    r2 = torch.full((64,), 0.01)
    with pytest.raises(ValueError, match="n_bins"):
        kw.wavefront_histogram(bvh, pts, r2, 0.1, 0)
    before = kw.wavefront_histogram.launches
    assert int(kw.wavefront_histogram(bvh, pts, r2, 0.1, 4).sum()) > 0
    assert kw.wavefront_histogram.launches == before     # the CPU launches nothing
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.pair_count_histogram(pts, 0.1, 4)
