"""The plain segment reductions of the port against the JAX reference's
Pallas kernels in interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment import segment_max_sorted as jax_seg_max  # noqa: E402
from repro.kernels.segment import segment_sum_sorted as jax_seg_sum  # noqa: E402
from repro_torch.kernels import segment as ks  # noqa: E402


def _inputs(n, segs, d, seed):
    """Sorted ids with gaps (empty segments) and ids outside [0, segs),
    which both sides clip."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(np.arange(-1, segs + 2, 2), n)).astype(np.int32)
    data = rng.standard_normal((n, d)).astype(np.float32)
    return ids, data


@pytest.mark.parametrize("n,segs,d", [(1, 3, 8), (130, 20, 8), (333, 64, 1)])
def test_segment_sum_plain_matches_pallas(n, segs, d):
    ids, data = _inputs(n, segs, d, n)
    want = np.asarray(jax_seg_sum(jnp.asarray(data), jnp.asarray(ids), segs,
                                  interpret=True))
    got = ks.segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(ids),
                                segs).numpy()
    # The reference sums by a one-hot matrix product, the port by a
    # scatter: float32 rounding of a different order only.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,segs,d", [(1, 3, 1), (130, 20, 8), (333, 64, 1)])
def test_segment_max_plain_matches_pallas(n, segs, d):
    ids, data = _inputs(n, segs, d, n + 1)
    data[::3] = -ks.SEG_NEG_BIG  # rows a caller excludes
    want = np.asarray(jax_seg_max(jnp.asarray(data), jnp.asarray(ids), segs,
                                  interpret=True))
    got = ks.segment_max_sorted(torch.from_numpy(data), torch.from_numpy(ids),
                                segs).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(-ks.SEG_NEG_BIG)).any()  # empty segments
