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
from test_torch_kernels_gpu import stencil_cells  # noqa: E402
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


def _real_slots(cell_pts):
    """(ncells+1, C) bool: a coordinate differs bitwise from float32(BIG)."""
    big = torch.tensor(kp.BIG, dtype=torch.float32).view(torch.int32)
    return (cell_pts.view(torch.int32) != big).any(-1)


def _class_decomposition(cell_pts, nbr, eps2, labels=None, core=None):
    """Both stencil outputs the way the stencil kernel computes them, cell by
    cell: the real slots R and padded slots P of every cell, |P| and minP
    (the least label over P's core slots), the padding vector tested once
    against each real candidate of the stencil, once against itself and
    once against each real query slot, and real x real pairs only."""
    ncells, cap, d = nbr.shape[0], cell_pts.shape[1], cell_pts.shape[2]
    sentinel = kp.SENTINEL_LABEL
    real = _real_slots(cell_pts)
    npad = (~real).sum(1)
    pad = torch.full((1, d), kp.BIG)

    def hits(q, c):
        return kp._hits(q, kp._sq_norms(q), c, kp._sq_norms(c), eps2)

    pad_pad = bool(hits(pad, pad)[0, 0])
    flat = cell_pts.reshape(-1, d)
    ids = kp._sink_safe(nbr, ncells)
    if labels is not None:
        min_p = torch.where(~real & core, labels, sentinel).amin(1)
        flat_lab = torch.where(core, labels, sentinel).reshape(-1)
    out = torch.empty((ncells, cap), dtype=torch.int32)
    for i in range(ncells):
        stencil = ids[i].tolist()
        cand = torch.cat([c * cap + torch.nonzero(real[c]).flatten()
                          for c in stencil])
        q_slots = torch.nonzero(real[i]).flatten()
        q, y = flat[i * cap + q_slots], flat[cand]
        n_p = int(npad[stencil].sum())
        h_qy, h_qp, h_py = hits(q, y), hits(q, pad)[:, 0], hits(pad, y)[0]
        if labels is None:
            real_ans = h_qy.sum(1) + h_qp.long() * n_p
            pad_ans = int(h_py.sum()) + pad_pad * n_p
        else:
            lab, m_p = flat_lab[cand], int(min_p[stencil].min())
            none = torch.full((len(q_slots), 1), sentinel)
            real_ans = torch.minimum(
                torch.cat([torch.where(h_qy, lab, sentinel), none], 1).amin(1),
                torch.where(h_qp, m_p, sentinel))
            pad_ans = min([sentinel] + lab[h_py].tolist()
                          + ([m_p] if pad_pad else []))
        row = torch.full((cap,), pad_ans, dtype=torch.int32)
        row[q_slots] = real_ans.to(torch.int32)
        out[i] = row
    return out


@pytest.mark.parametrize("cap", [1, 4, 16, 48])
@pytest.mark.parametrize("d", [1, 3])
def test_stencil_class_decomposition_is_exact(cap, d):
    """The stencil kernel's arithmetic (slot classes, the padding vector
    tested once, real x real pairs) equals both plain versions bit for bit
    at every slot, padded ones included, on cells whose padded slots sit
    anywhere and carry random labels and core flags, with out-of-range and
    sink ids, an all-padding and an all-real cell, a point at bitwise BIG
    and points a few ulps from BIG. Near BIG the formula's rounding, not
    the geometry, decides the test against the padding vector, and it
    hits."""
    cell_pts, nbr, labels, core = stencil_cells("cpu", 300, cap, d, cap + d)
    eps2 = float(np.float32(0.15) ** 2)
    real = _real_slots(cell_pts)
    assert not bool(real[0].any()) and bool(real[1].all()) and not bool(real[2, 0])
    assert bool((nbr < 0).any()) and bool((nbr > 300).any()) and bool((nbr == 300).any())
    near = real & (cell_pts.abs() > 1e14).all(-1)
    pad = torch.full((1, d), kp.BIG)
    q = cell_pts[near]
    near_hits = kp._hits(q, kp._sq_norms(q), pad, kp._sq_norms(pad), eps2)
    assert bool(near_hits.any())
    want = kp.stencil_count_plain(cell_pts, nbr, eps2)
    assert torch.equal(_class_decomposition(cell_pts, nbr, eps2), want)
    want = kp.stencil_min_label_plain(cell_pts, labels, core, nbr, eps2)
    assert torch.equal(_class_decomposition(cell_pts, nbr, eps2, labels, core), want)
    assert bool((want[~real[:-1]] != kp.SENTINEL_LABEL).any())


def test_near_big_points_miss_the_padding_too():
    """The test of a near-BIG point against the padding vector goes both
    ways, so it is computed, not assumed: at d = 3 some of the near-BIG
    points of ``stencil_cells`` miss it."""
    cell_pts, _, _, _ = stencil_cells("cpu", 300, 16, 3, 19)
    q = cell_pts[_real_slots(cell_pts) & (cell_pts.abs() > 1e14).all(-1)]
    pad = torch.full((1, 3), kp.BIG)
    hit = kp._hits(q, kp._sq_norms(q), pad, kp._sq_norms(pad), float(np.float32(0.15) ** 2))
    assert bool(hit.any()) and not bool(hit.all())


@pytest.mark.parametrize("cap", [1, 3, 32, 33, 70])
def test_slot_classes_pack_real_slots(cap):
    """Bit j % 32 of word j // 32 is set exactly where slot j is real."""
    cell_pts, _, _, _ = stencil_cells("cpu", 12, cap, 3, cap)
    words = kp.slot_classes(cell_pts)
    assert words.shape == (13, -(-cap // 32)) and words.dtype == torch.int32
    bits = (words.long() & 0xFFFFFFFF)[:, :, None] >> torch.arange(32)
    assert torch.equal((bits & 1).bool().reshape(13, -1)[:, :cap], _real_slots(cell_pts))
    assert not bool((bits & 1).reshape(13, -1)[:, cap:].any())


def test_shared_classes_make_one_mask_per_block():
    cell_pts, _, _, _ = stencil_cells("cpu", 12, 4, 3, 0)
    assert kp._classes(cell_pts) is not kp._classes(cell_pts)
    with kp.shared_classes(cell_pts):
        first = kp._classes(cell_pts)
        assert kp._classes(cell_pts) is first
        with kp.shared_classes(cell_pts.clone()):
            assert kp._classes(cell_pts) is first
    assert kp._classes(cell_pts) is not first
    assert torch.equal(first, kp.slot_classes_plain(cell_pts))


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


# --- XLA:CPU's flush of subnormals (ROADMAP C7) ------------------------------

_TINY = np.array([[1e-20, 0.0, 0.0]], np.float32)
_ORIGIN = np.zeros((1, 3), np.float32)


def test_subnormal_norm_flushes_at_eps_zero():
    """At eps = 0, (1e-20, 0, 0) against the origin: ‖x‖² = 1e-40 is
    subnormal, 0 in XLA, so d² = 0 and the pair is a hit (count 1, the
    origin's label), as the reference counts it; unflushed it missed."""
    x, y = jnp.asarray(_TINY), jnp.asarray(_ORIGIN)
    lab, core = np.array([7], np.int32), np.array([True])
    want = np.asarray(jops.eps_neighbor_counts(x, y, 0.0))
    got = tops.eps_neighbor_counts(torch.from_numpy(_TINY), torch.from_numpy(_ORIGIN), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 1
    want = np.asarray(jops.eps_min_label(x, y, jnp.asarray(lab), jnp.asarray(core), 0.0))
    got = tops.eps_min_label(torch.from_numpy(_TINY), torch.from_numpy(_ORIGIN),
                             torch.from_numpy(lab), torch.from_numpy(core), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 7


def _two_point_cell():
    """One cell holding (1e-20, 0, 0) and the origin, then the sink; the
    stencil is the cell itself and the sink."""
    cell_pts = np.full((2, 2, 3), kp.BIG, np.float32)
    cell_pts[0, 0], cell_pts[0, 1] = _TINY[0], _ORIGIN[0]
    nbr = np.array([[0] + [1] * 26], np.int32)
    labels = np.array([[5, 3], [kp.SENTINEL_LABEL] * 2], np.int32)
    core = np.array([[True, True], [False, False]])
    return cell_pts, nbr, labels, core


def test_subnormal_stencil_flushes_at_eps_zero():
    """The same pair in one ε-cell: the tiny point counts itself and the
    origin, 2 as in the reference (1 unflushed), and takes the origin's
    label."""
    cell_pts, nbr, labels, core = _two_point_cell()
    want = np.asarray(jops.cell_stencil_counts(jnp.asarray(cell_pts), jnp.asarray(nbr), 0.0))
    got = tops.cell_stencil_counts(torch.from_numpy(cell_pts), torch.from_numpy(nbr), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 2
    want = np.asarray(jops.cell_stencil_min_label(
        jnp.asarray(cell_pts), jnp.asarray(labels), jnp.asarray(core), jnp.asarray(nbr), 0.0))
    got = tops.cell_stencil_min_label(
        torch.from_numpy(cell_pts), torch.from_numpy(labels), torch.from_numpy(core),
        torch.from_numpy(nbr), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 3


@pytest.mark.parametrize("d", [1, 3, 8])
def test_flush_path_equals_plain_path_on_normal_inputs(d):
    """Where every nonzero input is at least 2^-50, nothing in d² can be
    subnormal, so the plain versions skip the flushes: flushing anyway
    changes no bit of d²."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.uniform(-1, 1, (50, d)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (70, d)).astype(np.float32))
    y[::7] = 0.0
    assert not kp._flush_needed(x, y)
    plain = kp._d2(x, kp._sq_norms(x), y, kp._sq_norms(y))
    flushed = kp._d2(x, kp._sq_norms(x, True), y, kp._sq_norms(y, True), True)
    assert torch.equal(plain.view(torch.int32), flushed.view(torch.int32))
    assert kp._flush_needed(x, torch.tensor([[2.0 ** -51] * d]))
