"""The plain segment reductions of the port against the JAX reference's
Pallas kernels in interpret mode, and the wrapper's launch plan."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels_gpu import SEGMENT_PATTERNS, segment_pattern, sum_bound  # noqa: E402
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


@pytest.mark.parametrize("d", [1, 3, 8, 9])
@pytest.mark.parametrize("name", SEGMENT_PATTERNS)
def test_segment_plain_matches_pallas_on_catalog_patterns(name, d):
    """The catalog's id patterns over two kernel blocks of rows: sums within
    the bound of two summation orders (the reference sums a tile by a
    one-hot product, the port by a scatter in row order), count column and
    maxima exact."""
    ids, xs, xm, segs = segment_pattern(name, d, d)
    ti = torch.from_numpy(ids)
    xs_t = torch.from_numpy(xs)
    want = np.asarray(jax_seg_sum(jnp.asarray(xs), jnp.asarray(ids), segs,
                                  interpret=True))
    got = ks.segment_sum_sorted(xs_t, ti, segs)
    bound = sum_bound(xs_t, ti, segs, ks.segment_sum_sorted_plain).numpy()
    assert (np.abs(got.numpy() - want) <= bound).all()
    if d > 1:
        np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    want = np.asarray(jax_seg_max(jnp.asarray(xm), jnp.asarray(ids), segs,
                                  interpret=True))
    got = ks.segment_max_sorted(torch.from_numpy(xm), ti, segs).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,plan", [
    (0, []), (1, []), (ks.CHUNK_ROWS, []), (ks.CHUNK_ROWS + 1, [4]),
    (1 << 20, [1024]), (1 << 24, [16384, 16]),
    (ks.CHUNK_ROWS ** 2 + 1, [2 * ks.CHUNK_ROWS + 2, 6])])
def test_carry_plan_levels(n, plan):
    """Each level holds two records per block of the level before, until
    one block holds a level."""
    assert ks.carry_plan(n) == plan
    assert ks.carry_rows(n) == sum(-(-r // 4) * 4 for r in plan)


def test_chunk_rows_match_the_kernel_source():
    src = (Path(ks.__file__).parent / "csrc" / "segment.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    rows = int(re.search(r"constexpr int kRows = (\d+);", src).group(1))
    assert threads * rows == ks.CHUNK_ROWS


def test_vector_path_needs_width_and_alignment():
    ids = torch.zeros(64, dtype=torch.int32)
    for d in (1, 8):
        x = torch.zeros(64, d)
        assert ks.vector_path(x, ids)
        assert not ks.vector_path(x[1:], ids[1:])   # ids 4 bytes off
    assert not ks.vector_path(torch.zeros(64, 1)[1:], ids[:63])  # rows 4 bytes off
    assert ks.vector_path(torch.zeros(64, 8)[1:], ids[:63])      # 32 bytes off
    for d in (2, 3, 4, 9):
        assert not ks.vector_path(torch.zeros(64, d), ids)
