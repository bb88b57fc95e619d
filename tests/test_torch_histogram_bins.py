"""The histogram's bins from exact squared-distance thresholds, on the CPU.

On the card, up to ``PRIVATE_HISTOGRAM_BINS`` bins, HISTOGRAM's bin of a
pair is the number of thresholds t_k at or below its d² (t_k the least
float32 whose bin is >= k, found by bisection in a prologue kernel),
without a correctly rounded square root or division: a first bin from an
approximate reciprocal square root, which the thresholds settle wherever
it lies near an edge. Its plain twins here, ``histogram_thresholds`` and
``bins_from_thresholds``, must give exactly ``histogram_bins`` (the IEEE
sequence the kernel's old path and its plain version use) and the JAX
reference's bins (``repro/core/correlation.py``'s formula run in
``jax.numpy``) on every float32 within 64 ulps of each threshold and on
random squared distances up to fl(r_max)²; and the kernel's rule, run here
with a reciprocal square root 2 ulps off (its documented bound), must too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import wavefront as kw  # noqa: E402

R_MAX = [1e-4, 3e-3, 0.1, 1.0]
N_BINS = [1, 3, 7, 16, 100, 6145]
ULPS = 64


def squared_distances(r_max: float, n_bins: int, t: torch.Tensor) -> np.ndarray:
    """float32 d²: every float within ULPS ulps of each threshold, and 10^5
    random ones in [0, fl(r_max)²], from a seed."""
    rng = np.random.default_rng(n_bins)
    r32 = np.float32(r_max)
    rand = (rng.random(100_000).astype(np.float32) * (r32 * r32)).astype(np.float32)
    bits = t.view(torch.int32).numpy().astype(np.int64)[:, None] + np.arange(-ULPS, ULPS + 1)
    near = np.clip(bits, 0, None).astype(np.int32).view(np.float32).ravel()
    return np.concatenate([rand, near, np.float32([0.0, r32 * r32])])


def reference_bins(d2: np.ndarray, r_max: float, n_bins: int) -> np.ndarray:
    """The reference's bin (``repro/core/correlation.py:35-36``), jitted
    with r_max a traced float32 and n_bins static, as the reference's
    ``pair_count_histogram`` is. (With r_max a constant of the jitted
    function instead, XLA folds ``/ r_max * n_bins`` into one product,
    whose rounding moves d² within a few ulps of an edge to the next bin.)"""
    @jax.jit
    def fn(x, r_max_f):
        b = jnp.floor(jnp.sqrt(jnp.maximum(x, 1e-30)) / r_max_f * n_bins)
        return jnp.clip(b.astype(jnp.int32), 0, n_bins - 1)
    return np.asarray(fn(jnp.asarray(d2), jnp.asarray(r_max, jnp.float32)))


@pytest.mark.parametrize("n_bins", N_BINS)
@pytest.mark.parametrize("r_max", R_MAX)
def test_thresholds_give_histogram_bins(r_max, n_bins):
    t = kw.histogram_thresholds(r_max, n_bins)
    assert t.dtype == torch.float32 and t.shape == (n_bins - 1,)
    assert not torch.isnan(t).any()                      # every bin is reached
    assert bool((t[1:] >= t[:-1]).all())
    d2 = torch.from_numpy(squared_distances(r_max, n_bins, t))
    want = kw.histogram_bins(d2, r_max, n_bins)
    assert torch.equal(kw.bins_from_thresholds(d2, t), want)
    # t_k is the least float of bin >= k: the one below it is in a lower bin.
    k = torch.arange(1, n_bins)
    below = torch.nextafter(t, torch.zeros(()))
    assert bool((kw.histogram_bins(t, r_max, n_bins) >= k).all())
    assert bool(((kw.histogram_bins(below, r_max, n_bins) < k) | (t == 0)).all())


@pytest.mark.parametrize("n_bins", N_BINS)
@pytest.mark.parametrize("r_max", R_MAX)
def test_thresholds_give_reference_bins(r_max, n_bins):
    t = kw.histogram_thresholds(r_max, n_bins)
    d2 = squared_distances(r_max, n_bins, t)
    got = kw.bins_from_thresholds(torch.from_numpy(d2), t)
    np.testing.assert_array_equal(got.numpy(), reference_bins(d2, r_max, n_bins))


def guarded_bins(d2, t, r_max: float, n_bins: int, ulps: int,
                 band: float = 2.0 ** -18) -> torch.Tensor:
    """The walk's rule (``threshold_bin`` in ``csrc/wavefront.cu``) with a
    reciprocal square root ``ulps`` ulps from the correctly rounded one: x
    = d² · rsqrt(d²) · fl(n_bins / r_max), its floor clipped, kept unless x
    lies within x · ``band`` of an integer, where the thresholds decide."""
    f32 = torch.float32
    dd = torch.maximum(d2, torch.tensor(1e-30, dtype=f32))
    rs = dd.double().rsqrt().float()
    toward = torch.full_like(rs, float("inf") if ulps > 0 else 0.0)
    for _ in range(abs(ulps)):
        rs = torch.nextafter(rs, toward)
    scale = torch.tensor(float(n_bins), dtype=f32) / torch.tensor(r_max, dtype=f32)
    x = (dd * rs) * scale
    whole = torch.floor(x)
    frac = x - whole
    near = ~((frac > x * band) & (frac < 1 - x * band))
    return torch.where(near, kw.bins_from_thresholds(d2, t), whole.clamp(0, n_bins - 1).long())


@pytest.mark.parametrize("n_bins", [1, 3, 7, 16, kw.PRIVATE_HISTOGRAM_BINS])
@pytest.mark.parametrize("r_max", R_MAX)
def test_guarded_first_bin_is_exact(r_max, n_bins):
    """A first bin from a reciprocal square root 2 ulps off either way,
    settled by the thresholds within x · 2^-18 of an edge, is the IEEE bin
    on every float32 near a threshold and on random d² up to fl(r_max)²."""
    t = kw.histogram_thresholds(r_max, n_bins)
    d2 = torch.from_numpy(squared_distances(r_max, n_bins, t))
    want = kw.histogram_bins(d2, r_max, n_bins)
    for ulps in (-2, 2):
        assert torch.equal(guarded_bins(d2, t, r_max, n_bins, ulps), want)


def test_guard_band_is_needed():
    """Without the band (the thresholds deciding only where x is an
    integer) the same first bin misses the IEEE bin next to an edge."""
    t = kw.histogram_thresholds(0.1, 16)
    d2 = torch.from_numpy(squared_distances(0.1, 16, t))
    want = kw.histogram_bins(d2, 0.1, 16)
    for ulps in (-2, 2):
        assert not torch.equal(guarded_bins(d2, t, 0.1, 16, ulps, band=0.0), want)


def test_cpu_wrappers_are_the_twins():
    """On the CPU the prologue's wrapper is the bisection twin and the
    probe of the walk's rule is ``bins_from_thresholds``; neither
    launches anything."""
    before = kw.histogram_edges.launches
    t = kw.histogram_edges(0.05, 16, "cpu")
    assert torch.equal(t.view(torch.int32), kw.histogram_thresholds(0.05, 16).view(torch.int32))
    assert kw.histogram_edges(0.05, 1, "cpu").shape == (0,)
    d2 = torch.linspace(0.0, 0.05 ** 2, 1001)
    assert torch.equal(kw.threshold_bins_rn(d2, t, 0.05), kw.histogram_bins(d2, 0.05, 16))
    assert kw.histogram_edges.launches == before
    with pytest.raises(ValueError, match="n_bins"):
        kw.histogram_edges(0.05, 0, "cpu")


def test_histogram_bins_convert_as_the_kernel():
    """Past the bins, +inf goes to the last bin and NaN to bin 0, as the
    kernel's saturating float-to-int conversion takes them."""
    d2 = torch.tensor([float("inf"), 3.0e38, float("nan"), 0.0, 1e-40])
    got = kw.histogram_bins(d2, 1e-3, 16)
    assert got.tolist() == [15, 15, 0, 0, 0]
