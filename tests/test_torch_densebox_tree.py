"""DenseBox's tree of dense cells and loose points: its leaves, its query
order, and its two epilogues' plain versions against a brute-force
oracle that uses no tree, exactly, on points at ε and on radii at a
cell's farthest corner; ``fdbscan_densebox`` against the JAX reference on
a lattice whose points lie at exactly ε from their neighbours."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.dbscan import fdbscan_densebox as jax_densebox  # noqa: E402
from repro_torch.core.cell_grid import cell_box  # noqa: E402
from repro_torch.core.dbscan import (densebox_tree, fdbscan_densebox,  # noqa: E402
                                     seg_min_per_point)
from repro_torch.core.geometry import point_aabb_dist2, sum_sq  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

BIG = 2**31 - 1


def _pairs(fn, c, *cols):
    """``fn(centre, *column rows)`` for every centre of ``c`` (q, 3) and
    every row of the (m, 3) ``cols``, as a (q, m) tensor."""
    q, m = c.shape[0], cols[0].shape[0]
    rows = [x[None].expand(q, m, 3).reshape(-1, 3) for x in cols]
    return fn(c[:, None].expand(q, m, 3).reshape(-1, 3), *rows).reshape(q, m)


def oracle(t, centers, r2, label, scan_lab):
    """Per query, DENSE_COUNT's count and DENSE_MIN_LABEL's label by brute
    force over the grid: each loose point within r by the point test
    (giving its ``label``); each dense cell whose box the sphere touches
    taken whole where its farthest corner, ``sum((|c - mid| + half)^2)``,
    is within r² (its run's length, its least ``scan_lab``), else each of
    its points within r by the point test (giving its ``scan_lab``)."""
    g, pts = t.grid, t.pts_sorted
    dense = t.dense
    loose = torch.nonzero(~dense).flatten()
    heads = torch.nonzero(dense & g.is_run_head()).flatten()
    members = torch.nonzero(dense).flatten()
    cell_of = torch.searchsorted(heads, g.run_start[members].long())

    near = _pairs(lambda c, p: sum_sq(p - c), centers, pts) <= r2[:, None]
    lo, hi = cell_box(g, g.cell_coord_sorted[heads])
    touch = _pairs(point_aabb_dist2, centers, lo, hi)
    half = torch.tensor(t.half, dtype=torch.float32)
    far = _pairs(lambda c, m: sum_sq((c - m).abs() + half), centers, (lo + hi) * 0.5)
    box = touch <= r2[:, None]
    whole = box & (far <= r2[:, None])
    part = box & ~whole

    length = g.run_length[heads].long()
    count = (near[:, loose].sum(1) + (whole * length).sum(1)
             + (near[:, members] & part[:, cell_of]).sum(1))
    cell_min = torch.full((heads.numel(),), BIG, dtype=torch.int64).scatter_reduce(
        0, cell_of, scan_lab[members].long(), "amin")
    cand = torch.cat([torch.where(near[:, loose], label[loose].long(), BIG),
                      torch.where(whole, cell_min, BIG),
                      torch.where(near[:, members] & part[:, cell_of],
                                  scan_lab[members].long(), BIG)], 1)
    return count, cand.min(1).values, {"whole": int(whole.sum()), "part": int(part.sum())}


def _radii_at_boundaries(t, rng):
    """A radius per query set to a distance the tests compute: the d² of a
    point (at ε), a cell's far corner d² (taken whole, by the ≤), or one
    float below it (scanned), spread over the queries."""
    g, pts = t.grid, t.pts_sorted
    n = pts.shape[0]
    heads = torch.nonzero(t.dense & g.is_run_head()).flatten()
    lo, hi = cell_box(g, g.cell_coord_sorted[heads])
    mid = (lo + hi) * 0.5
    half = torch.tensor(t.half, dtype=torch.float32)
    j = torch.from_numpy(rng.integers(0, n, n))
    k = torch.from_numpy(rng.integers(0, heads.numel(), n))
    at_point = sum_sq(pts[j] - pts)
    at_far = sum_sq((pts - mid[k]).abs() + half)
    below_far = torch.nextafter(at_far, torch.zeros_like(at_far))
    pick = torch.from_numpy(rng.integers(0, 3, n))
    r2 = torch.where(pick == 0, at_point, torch.where(pick == 1, at_far, below_far))
    return r2.contiguous(), int((pick > 0).sum())


def _lattice(step: int = 4, side: int = 12):
    """Points on a lattice of pitch 2^-4 inside [0, 1)^3, some sites
    doubled or tripled: neighbours at exactly ε = 2^-4 apart (d² exact),
    cells of ε/√3 holding one to three points, whose far corners from
    their own points lie below ε² and from a neighbour's above it."""
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    keep = g[rng.random(len(g)) < 0.6]
    twice = keep[rng.random(len(keep)) < 0.3]
    pts = np.concatenate([keep, twice, twice[rng.random(len(twice)) < 0.4]]) * 2.0 ** -step
    return (pts + 2.0 ** -7).astype(np.float32)


CASES = ("clustered", "lattice_at_eps", "radii_at_far_corners", "coincident")


def _case(case, rng):
    if case == "lattice_at_eps":
        return torch.from_numpy(_lattice()), 2.0 ** -4, 3
    if case == "coincident":
        p = np.concatenate([np.repeat(rng.uniform(0, 1, (3, 3)), 40, 0),
                            rng.uniform(0, 1, (200, 3))]).astype(np.float32)
        return torch.from_numpy(p), 0.08, 3
    return torch.from_numpy(make_clustered_points(rng, 700)), 0.05, 4


@pytest.mark.parametrize("case", CASES)
def test_plain_epilogues_equal_the_brute_force_oracle(case):
    """Both plain versions on the tree of cells and loose points, every
    point a query (a tenth masked out), equal the oracle exactly: counts
    without early exit, the core flag and counts below it with
    ``stop_at``, and min labels; with per-query radii at a point's d², at
    a cell's far corner and one float below it."""
    rng = np.random.default_rng(CASES.index(case))
    pts, eps, min_pts = _case(case, rng)
    t = densebox_tree(pts, eps, min_pts)
    n = pts.shape[0]
    r2 = t.r2
    if case == "radii_at_far_corners":
        r2, at = _radii_at_boundaries(t, rng)
        assert at > n // 2
    scan_lab = torch.from_numpy(rng.permutation(n).astype(np.int32))
    core = torch.from_numpy(rng.random(n) < 0.5) | t.dense
    label = torch.where(core, scan_lab, n)
    cell_lab = seg_min_per_point(scan_lab, t.grid.run_start, t.grid.run_length)
    words = t.words(torch.where(t.dense, cell_lab, label))
    qmask = torch.from_numpy(rng.random(n) < 0.9)
    want_count, want_label, hits = oracle(t, t.pts_sorted, r2, label, scan_lab)
    assert hits["whole"] > 0 and hits["part"] > 0
    lanes = torch.nonzero(qmask).flatten()

    got = kw.wavefront_dense_count_plain(t.bvh, t.pts_sorted, r2, words, t.pts_sorted,
                                         t.half, None, qmask)
    np.testing.assert_array_equal(got[lanes].numpy(), want_count[lanes].numpy())
    assert int(got[~qmask].abs().sum()) == 0
    for stop in (2, min_pts):
        got = kw.wavefront_dense_count_plain(t.bvh, t.pts_sorted, r2, words,
                                             t.pts_sorted, t.half, stop, qmask)[lanes]
        want = want_count[lanes]
        np.testing.assert_array_equal((got >= stop).numpy(), (want >= stop).numpy())
        np.testing.assert_array_equal(got[want < stop].numpy(), want[want < stop].numpy())
    got = kw.wavefront_dense_min_label_plain(t.bvh, t.pts_sorted, r2, words, t.pts_sorted,
                                             scan_lab, t.half, qmask, n)
    want = torch.where(want_label >= BIG, n, want_label).clamp(max=n)
    np.testing.assert_array_equal(got[lanes].numpy(), want[lanes].numpy())
    assert bool((got[~qmask] == n).all())


@pytest.mark.parametrize("min_pts", [1, 2, 5, 200])
def test_tree_leaves_are_run_heads_and_loose_points(min_pts):
    """The tree's objects are exactly the dense cells' run heads (as cell
    leaves, with their run) and the loose points (as point leaves, a run
    of 1), in grid order; its words map each leaf back to them; the query
    order is a permutation of the n points that lists each cell's run
    where the leaf order has the cell."""
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(7), 900))
    t = densebox_tree(pts, 0.05, min_pts)
    n, g = pts.shape[0], t.grid
    heads = t.dense & g.is_run_head()
    want = torch.nonzero(heads | ~t.dense).flatten().int()
    assert torch.equal(t.obj, want)
    assert t.bvh.num_leaves == want.numel()
    assert torch.equal(t.kind == kw.DENSE_CELL, heads[want.long()])
    assert torch.equal(t.run_length, torch.where(heads, g.run_length, 1)[want.long()])
    words = t.words(torch.arange(n, dtype=torch.int32))
    leaf_obj = t.obj[t.bvh.leaf_perm.long()]
    assert torch.equal(words[:, 0], leaf_obj)
    assert torch.equal(words[:, 2], leaf_obj)
    assert torch.equal(t.order.sort().values, torch.arange(n, dtype=torch.int32))
    # Each leaf's run, in leaf order, is the order.
    runs = torch.cat([torch.arange(int(s), int(s) + int(ln)) for s, ln in words[:, :2]])
    assert torch.equal(t.order.long(), runs)


def test_single_object_tree_pads_an_empty_leaf():
    """All points in one dense cell: one object, so the tree gets a second
    leaf with its box and an empty run, which changes no count or label."""
    pts = torch.full((50, 3), 0.25, dtype=torch.float32)
    t = densebox_tree(pts, 0.01, 2)
    assert t.bvh.num_leaves == 2 and t.run_length.tolist() == [50, 0]
    assert torch.equal(t.order, torch.arange(50, dtype=torch.int32))
    got = fdbscan_densebox(pts.numpy(), 0.01, 2, device="cpu")
    want = jax_densebox(jnp.asarray(pts.numpy()), 0.01, 2)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("use_64bit", [True, False])
def test_densebox_lattice_at_eps_against_reference(use_64bit):
    """Neighbours at exactly ε: labels, core mask and rounds equal the JAX
    reference's, on 64- and 32-bit codes."""
    pts = _lattice()
    got = fdbscan_densebox(pts, 2.0 ** -4, 3, use_64bit, device="cpu")
    want = jax_densebox(jnp.asarray(pts), 2.0 ** -4, 3, use_64bit=use_64bit)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.core_mask.sum()) > 0 and int((got.labels >= 0).sum()) < pts.shape[0]


def test_scan_records_hold_each_point_and_its_label_bits():
    """A scan record is the grid-sorted point's x, y, z and its label's
    int32 bits (0 without labels), one 16-byte row a point."""
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.standard_normal((257, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 257).astype(np.int32))
    for scan_lab, want in ((lab, lab), (None, torch.zeros(257, dtype=torch.int32))):
        rec = kw.dense_scan_records(pts, scan_lab)
        assert rec.shape == (257, 4) and rec.dtype == torch.float32 and rec.is_contiguous()
        assert torch.equal(rec[:, :3], pts)
        assert torch.equal(rec[:, 3].contiguous().view(torch.int32), want)
