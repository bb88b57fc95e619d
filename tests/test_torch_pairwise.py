"""The port's ε-pairwise ops (``kernels/ops.py``, ``kernels/pairwise.py``)
on the CPU against the JAX reference's Pallas kernels in interpret mode.

Both sides compute d² = ‖x‖² + ‖y‖² − 2x·y in float32, but XLA may sum
in another order or fuse a multiply-add, so they agree exactly only away
from ties at ε (ROADMAP C2). Every input therefore goes through
:func:`drop_ties`: no pair keeps |d²₆₄ − ε²| < TIE_BAND·ε², with d²₆₄
the exact squared distance of the float32 points in float64. TIE_BAND =
1e-3 is far wider than either formula's rounding: at the tests' widest
case (d = 64, coordinates in [0, 1)) that rounding is below
(d + 2)·2^-24·(‖x‖² + ‖y‖² + 2|x·y|) ≈ 3e-4, against a band of 1e-3·ε² ≈ 7e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import fdbscan_grid as jgrid  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import fdbscan_grid as tgrid  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pairwise as kp  # noqa: E402

TIE_BAND = 1e-3


def _near_ties(a, b, eps):
    e2 = np.float64(np.float32(eps)) ** 2
    d2 = ((a.astype(np.float64)[:, None] - b.astype(np.float64)[None]) ** 2).sum(-1)
    return np.abs(d2 - e2) < TIE_BAND * e2


def drop_ties(pts, eps, others=None):
    """The rows of ``pts`` that make no near-tie pair at ε: against
    ``others`` when given, else among themselves, keeping rows in order
    and dropping each that would tie with one kept before it."""
    if others is not None:
        return pts[~_near_ties(pts, others, eps).any(1)]
    near = _near_ties(pts, pts, eps)
    keep = []
    for i in range(len(pts)):
        if not near[i, keep].any():
            keep.append(i)
    return pts[keep]


def _cross_eps(x, y):
    """An ε with a few percent of the pairs inside: 1.3 times the 10%
    quantile of the cross distances."""
    d2 = ((x.astype(np.float64)[:, None] - y[None]) ** 2).sum(-1)
    return float(1.3 * np.sqrt(np.quantile(d2, 0.1)))


PAIR_SHAPES = [(1, 1, 1), (37, 130, 3), (129, 257, 5), (200, 300, 64)]


def _pair_inputs(m, n, d):
    rng = np.random.default_rng(100 * d + m)
    x = rng.uniform(0, 1, (m, d)).astype(np.float32)
    y = rng.uniform(0, 1, (n, d)).astype(np.float32)
    eps = _cross_eps(x, y)
    y = drop_ties(y, eps)            # tie-free for the self-join y vs y
    x = drop_ties(x, eps, y)         # and for x vs y
    assert len(x) and len(y)
    labels = rng.permutation(len(y)).astype(np.int32)
    core = rng.random(len(y)) < 0.4
    return x, y, labels, core, eps


@pytest.mark.parametrize("m,n,d", PAIR_SHAPES)
def test_eps_neighbor_counts_exact(m, n, d):
    x, y, _, _, eps = _pair_inputs(m, n, d)
    want = np.asarray(jops.eps_neighbor_counts(jnp.asarray(x), jnp.asarray(y), eps))
    got = tops.eps_neighbor_counts(torch.from_numpy(x), torch.from_numpy(y), eps)
    assert got.dtype == torch.int32 and got.shape == (len(x),)
    np.testing.assert_array_equal(got.numpy(), want)
    # A self-join counts each point itself.
    self_counts = tops.eps_neighbor_counts(torch.from_numpy(y), torch.from_numpy(y), eps)
    np.testing.assert_array_equal(
        self_counts.numpy(),
        np.asarray(jops.eps_neighbor_counts(jnp.asarray(y), jnp.asarray(y), eps)))
    assert bool((self_counts >= 1).all())


@pytest.mark.parametrize("m,n,d", PAIR_SHAPES)
def test_eps_min_label_exact(m, n, d):
    x, y, labels, core, eps = _pair_inputs(m, n, d)
    want = np.asarray(jops.eps_min_label(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(labels), jnp.asarray(core), eps))
    got = tops.eps_min_label(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(labels), torch.from_numpy(core), eps)
    np.testing.assert_array_equal(got.numpy(), want)
    # No core candidate at all: every row is the sentinel.
    none = tops.eps_min_label(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(labels),
                              torch.zeros(len(y), dtype=torch.bool), eps)
    assert bool((none == kp.SENTINEL_LABEL).all())


def test_eps_squared_is_float32_arithmetic():
    for eps in (0.22, 1 / 3, 2.0 ** -8, 1e-3):
        e = np.float32(eps)
        assert tops.eps_squared(eps) == float(e * e)


def _stencil_inputs(cap):
    pts = drop_ties(make_clustered_points(np.random.default_rng(11), 300), 0.22)
    dims = jgrid.grid_dims_for(np.zeros(3), np.ones(3), 0.22)
    assert dims == (5, 5, 5)
    bins = tgrid.bin_points(torch.from_numpy(pts), np.zeros(3, np.float32), 0.22,
                            dims, cap)
    nbr = tgrid.stencil_neighbor_map(dims, device="cpu")
    rng = np.random.default_rng(cap)
    slot = bins.slot_of_point.long()
    labels = tgrid._scatter_slots(
        torch.from_numpy(rng.permutation(len(pts)).astype(np.int32)),
        kp.SENTINEL_LABEL, bins, slot)
    core = tgrid._scatter_slots(torch.from_numpy(rng.random(len(pts)) < 0.5),
                                False, bins, slot, dtype=torch.bool)
    # Occupied slots: the reference's output is garbage elsewhere.
    occupied = slot[slot < bins.num_cells * cap]
    return bins.cell_pts, nbr, labels, core, occupied


@pytest.mark.parametrize("cap", [4, 32])
def test_cell_stencil_ops_exact_at_occupied_slots(cap):
    cell_pts, nbr, labels, core, occupied = _stencil_inputs(cap)
    jpts, jnbr = jnp.asarray(cell_pts.numpy()), jnp.asarray(nbr.numpy())
    want = np.asarray(jops.cell_stencil_counts(jpts, jnbr, 0.22)).reshape(-1)
    got = tops.cell_stencil_counts(cell_pts, nbr, 0.22)
    assert got.shape == (125, cap) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.view(-1)[occupied].numpy(), want[occupied])
    want = np.asarray(jops.cell_stencil_min_label(
        jpts, jnp.asarray(labels.numpy()), jnp.asarray(core.numpy()), jnbr,
        0.22)).reshape(-1)
    got = tops.cell_stencil_min_label(cell_pts, labels, core, nbr, 0.22)
    np.testing.assert_array_equal(got.view(-1)[occupied].numpy(), want[occupied])
    assert bool((got.view(-1)[occupied] != kp.SENTINEL_LABEL).any())


def test_stencil_ids_out_of_range_read_the_sink():
    cell_pts, nbr, labels, core, _ = _stencil_inputs(4)
    bad = nbr.clone()
    bad[bad == 125] = -7                         # some below range ...
    bad[::2][bad[::2] == -7] = 999               # ... and some above
    eps2 = tops.eps_squared(0.22)
    assert torch.equal(kp.stencil_count(cell_pts, bad, eps2),
                       kp.stencil_count(cell_pts, nbr, eps2))
    assert torch.equal(kp.stencil_min_label(cell_pts, labels, core, bad, eps2),
                       kp.stencil_min_label(cell_pts, labels, core, nbr, eps2))


def test_empty_inputs():
    eps2 = tops.eps_squared(0.5)
    x = torch.zeros((0, 3))
    y = torch.rand((5, 3))
    assert kp.pairwise_count(x, y, eps2).shape == (0,)
    assert torch.equal(kp.pairwise_count(y, x, eps2), torch.zeros(5, dtype=torch.int32))
    lab = kp.pairwise_min_label(y, x, torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.bool), eps2)
    assert bool((lab == kp.SENTINEL_LABEL).all())


def test_wrappers_check_inputs_and_cpu_launches_nothing():
    eps2 = tops.eps_squared(0.5)
    x = torch.rand((8, 3))
    for fn in (kp.stencil_count, kp.stencil_min_label, kp.pairwise_count,
               kp.pairwise_min_label):
        fn.launches = 0
    with pytest.raises(ValueError, match="float32"):
        kp.pairwise_count(x.double(), x, eps2)
    with pytest.raises(ValueError, match="feature"):
        kp.pairwise_count(x, x[:, :2].contiguous(), eps2)
    with pytest.raises(ValueError, match="labels"):
        kp.pairwise_min_label(x, x, torch.zeros(8, dtype=torch.int64),
                              torch.zeros(8, dtype=torch.bool), eps2)
    cell_pts = torch.full((3, 4, 3), kp.BIG)
    with pytest.raises(ValueError, match="nbr_map"):
        kp.stencil_count(cell_pts, torch.zeros((3, 27), dtype=torch.int32), eps2)
    kp.pairwise_count(x, x, eps2)
    kp.stencil_count(cell_pts, torch.full((2, 27), 2, dtype=torch.int32), eps2)
    assert kp.pairwise_count.launches == kp.stencil_count.launches == 0


@pytest.mark.parametrize("r,d", [(1, 3), (128, 5), (129, 64), (300, 257), (0, 2)])
def test_k_major_pads_rows_to_whole_tiles(r, d):
    """The all-pairs kernel's operand layout: (r, D) -> (D, rp), rp the
    least multiple of TILE at or above r, the padding zero."""
    t = torch.from_numpy(np.random.default_rng(r + d).random((r, d), dtype=np.float32))
    got = kp.k_major(t)
    rp = -(-r // kp.TILE) * kp.TILE
    assert got.shape == (d, rp) and got.dtype == torch.float32 and got.is_contiguous()
    assert rp % kp.TILE == 0 and rp - r < kp.TILE
    assert torch.equal(got[:, :r], t.t())
    assert not bool(got[:, r:].any())


def test_plain_d2_is_the_hit_test():
    """``_d2`` is the contract's d2, and a hit is d2 <= eps2 with ties
    included: eps2 set to a pair's own d2 makes that pair a hit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((40, 7), dtype=np.float32))
    y = torch.from_numpy(rng.random((50, 7), dtype=np.float32))
    xn, yn = kp._sq_norms(x), kp._sq_norms(y)
    d2 = kp._d2(x, xn, y, yn)
    eps2 = float(d2[5, 9])
    assert torch.equal(kp._hits(x, xn, y, yn, eps2), d2 <= d2[5, 9])
    assert bool(kp._hits(x, xn, y, yn, eps2)[5, 9])
    want = (d2 <= d2[5, 9]).sum(1, dtype=torch.int32)
    assert torch.equal(kp.pairwise_count(x, y, eps2), want)
