"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Marked ``gpu``: without a CUDA card every test here skips.

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX, so it also runs on a machine without it.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dbscan import fdbscan  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.geometry import point_aabb_dist2, scene_bounds  # noqa: E402
from repro_torch.data.pipeline import make_clustered_points  # noqa: E402
from repro_torch.core import fdbscan_grid as tgrid  # noqa: E402
from repro_torch.kernels import pairwise as kp  # noqa: E402
from repro_torch.kernels import segment as ks  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

tq = importlib.import_module("repro_torch.core.query")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree(cuda, n, seed):
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(seed), n)).to(cuda)
    return pts, build_bvh(pts, *scene_bounds(pts))


@pytest.mark.parametrize("q", [1, 127, 128, 129, 5000])
@pytest.mark.parametrize("stop_at", [None, 2, 5])
def test_wavefront_count_matches_plain(cuda, q, stop_at):
    pts, bvh = _tree(cuda, 4000, q)
    rng = np.random.default_rng(q + 1)
    centers = torch.from_numpy(rng.uniform(0, 1, (q, 3)).astype(np.float32)).to(cuda)
    r2 = torch.from_numpy(rng.uniform(0, 0.003, q).astype(np.float32)).to(cuda)
    got = kw.wavefront_count(bvh, centers, r2, stop_at=stop_at)
    want = kw.wavefront_count_plain(bvh, centers, r2, stop_at)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wavefront_self_join_in_leaf_order(cuda):
    pts, bvh = _tree(cuda, 6000, 7)
    r2 = torch.full((pts.shape[0],), 0.01 ** 2, device=cuda)
    got = kw.wavefront_count(bvh, pts, r2, order=bvh.leaf_perm)
    torch.testing.assert_close(got, kw.wavefront_count_plain(bvh, pts, r2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_wavefront_min_label_matches_plain(cuda, seed):
    pts, bvh = _tree(cuda, 5000, seed)
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    r2 = torch.full((n,), 0.012 ** 2, device=cuda)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    for mask in (core, ~core):
        got = kw.wavefront_min_label(bvh, pts, r2, labels, core, mask, n,
                                     order=bvh.leaf_perm)
        want = kw.wavefront_min_label_plain(bvh, pts, r2, labels, core, mask, n)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n,segs", [(1, 4), (1000, 7), (100_003, 5000)])
def test_segment_kernels_match_plain(cuda, n, segs):
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(np.sort(rng.integers(-2, segs + 2, n)).astype(np.int32)).to(cuda)
    data = torch.from_numpy(rng.standard_normal((n, 8), np.float32)).to(cuda)
    data[:, 0] = 1.0
    data[n - n // 5:] = 0.0  # a neutral tail, as the catalog's noise rows
    got = ks.segment_sum_sorted(data, ids, segs)
    want = ks.segment_sum_sorted_plain(data, ids, segs)
    # Atomics add in another order than the scatter: float32 rounding only.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    vals = data[:, 1:2].contiguous()
    vals[torch.from_numpy(rng.random(n) < 0.3).to(cuda)] = -ks.SEG_NEG_BIG
    torch.testing.assert_close(ks.segment_max_sorted(vals, ids, segs),
                               ks.segment_max_sorted_plain(vals, ids, segs),
                               rtol=0, atol=0)


SEGMENT_PATTERNS = ("one_segment", "every_row", "block_runs",
                    "block_runs_offset", "neutral_tail", "clipped_tail",
                    "clipped_ids")


def segment_pattern(name, d, seed, blocks=2):
    """``(ids, sum_rows, max_rows, num_segments)``, numpy, for one of the
    halo catalog's id patterns over about ``blocks`` kernel blocks of rows:
    one segment spanning every row; every row its own segment; runs of one
    block length, on block edges or offset by one; runs of 2-9 rows with one
    run of 1.5 blocks and a neutral tail of a fifth of the rows that carries
    the last id (``clipped_tail``: that id clipped to the last segment);
    sorted ids from below 0 to past the last segment. Every id in range
    occurs (the reference's dense contract). Column 0 of the sum rows is 1.0
    (the catalog's count column); a tenth of the max rows are excluded
    (``-SEG_NEG_BIG``)."""
    rng = np.random.default_rng(seed)
    c = ks.CHUNK_ROWS
    n = blocks * c + 5
    tail = 0
    if name == "one_segment":
        ids, segs = np.zeros(n), 4
    elif name == "every_row":
        ids, segs = np.arange(n), n
    elif name in ("block_runs", "block_runs_offset"):
        ids = (np.arange(n) + (name == "block_runs_offset")) // c
        segs = int(ids[-1]) + 2
    elif name in ("neutral_tail", "clipped_tail"):
        runs = list(rng.integers(2, 10, 4 * n // 5 // 6))
        runs.insert(len(runs) // 3, c + c // 2)
        ids = np.repeat(np.arange(len(runs)), runs)
        tail = len(ids) // 4
        ids = np.concatenate([ids, np.full(tail, ids[-1])])
        segs = len(runs) + 7 if name == "neutral_tail" else len(runs) - 3
    else:
        segs = 64
        ids = np.repeat(np.arange(-3, segs + 3),
                        rng.multinomial(n - segs - 6, np.ones(segs + 6) / (segs + 6)) + 1)
    n = len(ids)
    xs = rng.standard_normal((n, d)).astype(np.float32)
    if d > 1:
        xs[:, 0] = 1.0
    xm = rng.standard_normal((n, d)).astype(np.float32)
    xm[rng.random(n) < 0.1] = -ks.SEG_NEG_BIG
    if tail:
        xs[-tail:] = 0.0
        xm[-tail:] = -ks.SEG_NEG_BIG
    return ids.astype(np.int32), xs, xm, segs


def sum_bound(data, ids, segs, plain_sum):
    """Largest difference of two float32 summation orders of each segment:
    2 (m - 1) u sum|x| for m rows, u = 2^-24 (recursive summation's bound)."""
    m = torch.bincount(ids.long().clamp(0, segs - 1), minlength=segs).float()
    return (2.0 * (m - 1).clamp(min=0)[:, None] * 2.0 ** -24
            * plain_sum(data.abs(), ids, segs))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("d", [1, 3, 8, 9])
@pytest.mark.parametrize("name", SEGMENT_PATTERNS)
def test_segment_kernels_on_catalog_patterns(cuda, name, d):
    """Sums within the summation-order bound with the count column exact,
    maxima exact; two calls bit-equal; the scalar instance (a misaligned
    copy of the same rows) bit-equal to the vector instance."""
    for blocks in (2, 1100) if d in ks.VECTOR_WIDTHS else (2,):
        ids, xs, xm, segs = segment_pattern(name, d, d, blocks)
        ids = torch.from_numpy(ids).to(cuda)
        for x, wrapper, plain in (
                (xs, ks.segment_sum_sorted, ks.segment_sum_sorted_plain),
                (xm, ks.segment_max_sorted, ks.segment_max_sorted_plain)):
            x = torch.from_numpy(x).to(cuda)
            got = wrapper(x, ids, segs)
            want = plain(x, ids, segs)
            if wrapper is ks.segment_sum_sorted:
                assert bool(((got - want).abs() <= sum_bound(x, ids, segs, plain)).all())
                if d > 1:
                    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert torch.equal(_bits(wrapper(x, ids, segs)), _bits(got))
            # The same rows one float and one id past a 16-byte boundary.
            xo = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
            io = torch.empty(ids.numel() + 1, dtype=torch.int32, device=cuda)[1:].copy_(ids)
            assert not ks.vector_path(xo, io)
            assert torch.equal(_bits(wrapper(xo, io, segs)), _bits(got))


@pytest.mark.parametrize("n", [1, 2, 17, 31, 32, 33, 2047, 2049, 3 * 2048 + 7])
def test_segment_kernels_ragged_row_counts(cuda, n):
    """n below a warp and n not a multiple of the kernel's block of rows."""
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.int32)).to(cuda)
    segs = max(n // 3, 1)
    for d in (1, 8):
        x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda)
        got = ks.segment_sum_sorted(x, ids, segs)
        want = ks.segment_sum_sorted_plain(x, ids, segs)
        assert bool(((got - want).abs() <= sum_bound(x, ids, segs,
                                                     ks.segment_sum_sorted_plain)).all())
        torch.testing.assert_close(ks.segment_max_sorted(x, ids, segs),
                                   ks.segment_max_sorted_plain(x, ids, segs),
                                   rtol=0, atol=0)


def test_segment_kernels_on_misaligned_view(cuda):
    """``data[1:]`` and ``seg_ids[1:]``, contiguous views off a 16-byte
    boundary, take the scalar instance and give the aligned copy's bits."""
    ids, xs, _, segs = segment_pattern("neutral_tail", 1, 5, blocks=40)
    x = torch.from_numpy(xs).to(cuda)
    i = torch.from_numpy(ids).to(cuda)
    xv, iv = x[1:], i[1:]
    assert xv.is_contiguous() and not ks.vector_path(xv, iv)
    for wrapper in (ks.segment_sum_sorted, ks.segment_max_sorted):
        assert torch.equal(_bits(wrapper(xv, iv, segs)),
                           _bits(wrapper(xv.clone(), iv.clone(), segs)))


def test_segment_sum_is_deterministic(cuda):
    """Two calls on the catalog's shape of ids at 2^24 rows, whose neutral
    tail spans about 1600 blocks, give the same bits (no atomics)."""
    ids, xs, _, segs = segment_pattern("neutral_tail", 8, 9, blocks=1 << 13)
    x = torch.from_numpy(xs).to(cuda)
    i = torch.from_numpy(ids).to(cuda)
    first = ks.segment_sum_sorted(x, i, segs)
    for _ in range(3):
        assert torch.equal(_bits(ks.segment_sum_sorted(x, i, segs)), _bits(first))


def test_launch_counters_count_kernel_launches(cuda):
    pts, bvh = _tree(cuda, 300, 3)
    r2 = torch.full((300,), 0.05 ** 2, device=cuda)
    before = kw.wavefront_count.launches
    kw.wavefront_count(bvh, pts, r2)
    assert kw.wavefront_count.launches == before + 1


def _offsets(counts, dtype):
    return torch.cat([torch.zeros(1, dtype=dtype, device=counts.device),
                      torch.cumsum(counts, 0, dtype=dtype)])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("cut", [1, 2, 0])
def test_wavefront_fill_matches_plain(cuda, dtype, cut):
    """Exact capacity, half of it (truncation), and capacity 0."""
    pts, bvh = _tree(cuda, 6000, 11)
    r2 = torch.full((pts.shape[0],), 0.02 ** 2, device=cuda)
    offsets = _offsets(kw.wavefront_count(bvh, pts, r2), dtype)
    capacity = int(offsets[-1]) // cut if cut else 0
    got = kw.wavefront_fill(bvh, pts, r2, offsets, capacity, order=bvh.leaf_perm)
    want = kw.wavefront_fill_plain(bvh, pts, r2, offsets, capacity)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("capacity", [0, 1, 8, 512])
def test_wavefront_fixed_matches_plain(cuda, capacity):
    pts, bvh = _tree(cuda, 5000, 12)
    rng = np.random.default_rng(capacity)
    r2 = torch.from_numpy(rng.uniform(0, 0.03, 5000).astype(np.float32) ** 2).to(cuda)
    got = kw.wavefront_fixed(bvh, pts, r2, capacity, order=bvh.leaf_perm)
    want = kw.wavefront_fixed_plain(bvh, pts, r2, capacity)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_csr_device_makes_no_host_sync(cuda):
    pts, bvh = _tree(cuda, 4000, 13)
    pred = tq.within(pts, 0.02)
    counts = tq.query_count(bvh, pred)
    torch.cuda.synchronize()
    before = (kw.wavefront_count.launches, kw.wavefront_fill.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tq.query_csr_device(bvh, pred, 5000, order=bvh.leaf_perm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (kw.wavefront_count.launches, kw.wavefront_fill.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(res.offsets.diff(), counts, rtol=0, atol=0)


def _edge_case(cuda, case):
    """(tree points, queries, r2) of a tree edge case: a two-leaf tree;
    coincident points, whose zero-size boxes tie at d2 == r2 exactly (r2
    set to the plain version's own d2 from each query to one leaf); and
    queries outside the scene box."""
    rng = np.random.default_rng(len(case))
    if case == "two_leaves":
        pts = rng.uniform(0, 1, (2, 3)).astype(np.float32)
        queries = np.concatenate([pts, rng.uniform(-0.5, 1.5, (40, 3))])
        r2 = rng.uniform(0, 1, queries.shape[0]) ** 2
    elif case == "coincident_ties":
        base = rng.uniform(0, 1, (300, 3)).astype(np.float32)
        pts = np.repeat(base, 7, axis=0)[rng.permutation(2100)]
        queries = np.concatenate([pts[:500], rng.uniform(0, 1, (500, 3))])
        r2 = np.zeros(queries.shape[0])
    else:
        pts = make_clustered_points(rng, 3000)
        queries = rng.uniform(-1, 2, (2000, 3))
        queries[:, rng.integers(0, 3)] += 3.0    # all past one face
        r2 = rng.uniform(0, 3.5, queries.shape[0]) ** 2
    pts, queries, r2 = (torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
                        for a in (pts, queries, r2))
    if case == "coincident_ties":
        j = torch.from_numpy(rng.integers(0, pts.shape[0], queries.shape[0])).to(cuda)
        r2 = point_aabb_dist2(queries, pts[j], pts[j])
    return pts, queries, r2


def _assert_epilogues_match_plain(bvh, centers, r2, cuda):
    """COUNT (with and without early exit), MIN_LABEL, FILL (exact, half,
    int64 offsets) and FIXED (overflowing, ample) bit-equal to plain, the
    queries taken by threads in a random order."""
    q, n = centers.shape[0], bvh.num_leaves
    rng = np.random.default_rng(q + n)
    order = torch.from_numpy(rng.permutation(q).astype(np.int32)).to(cuda)
    for stop in (None, 2):
        torch.testing.assert_close(
            kw.wavefront_count(bvh, centers, r2, stop_at=stop, order=order),
            kw.wavefront_count_plain(bvh, centers, r2, stop), rtol=0, atol=0)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    mask = torch.from_numpy(rng.random(q) < 0.8).to(cuda)
    torch.testing.assert_close(
        kw.wavefront_min_label(bvh, centers, r2, labels, core, mask, n, order=order),
        kw.wavefront_min_label_plain(bvh, centers, r2, labels, core, mask, n),
        rtol=0, atol=0)
    counts = kw.wavefront_count(bvh, centers, r2)
    assert int(counts.sum()) > 0
    for dtype, cut in ((torch.int32, 1), (torch.int32, 2), (torch.int64, 1)):
        offsets = _offsets(counts, dtype)
        cap = int(offsets[-1]) // cut
        torch.testing.assert_close(
            kw.wavefront_fill(bvh, centers, r2, offsets, cap, order=order),
            kw.wavefront_fill_plain(bvh, centers, r2, offsets, cap), rtol=0, atol=0)
    for cap in (1, int(counts.max())):
        for g, w in zip(kw.wavefront_fixed(bvh, centers, r2, cap, order=order),
                        kw.wavefront_fixed_plain(bvh, centers, r2, cap)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["two_leaves", "coincident_ties", "outside_scene"])
def test_wavefront_edge_trees_match_plain(cuda, case):
    pts, queries, r2 = _edge_case(cuda, case)
    bvh = build_bvh(pts, *scene_bounds(pts))
    got, want = kw.pack_tree(bvh), kw.pack_tree_plain(bvh)
    for f in got._fields:
        torch.testing.assert_close(getattr(got, f).view(torch.int32),
                                   getattr(want, f).view(torch.int32), rtol=0, atol=0)
    _assert_epilogues_match_plain(bvh, queries, r2, cuda)


@pytest.mark.parametrize("case", ["sentinel_below_labels", "no_core"])
def test_wavefront_min_label_sentinels(cuda, case):
    """The keys hold ``sentinel`` for objects that are not core: with a
    sentinel below half the labels, and with no core object at all."""
    pts, bvh = _tree(cuda, 5000, 3)
    n = pts.shape[0]
    rng = np.random.default_rng(len(case))
    r2 = torch.full((n,), 0.015 ** 2, device=cuda)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    sentinel = n // 2
    if case == "no_core":
        core[:] = False
        sentinel = n
    for mask in (torch.ones_like(core), core | torch.from_numpy(rng.random(n) < 0.3).to(cuda)):
        got = kw.wavefront_min_label(bvh, pts, r2, labels, core, mask, sentinel,
                                     order=bvh.leaf_perm)
        want = kw.wavefront_min_label_plain(bvh, pts, r2, labels, core, mask, sentinel)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if case == "no_core":
            assert bool((got == sentinel).all())


def test_wavefront_misaligned_records_raise(cuda, monkeypatch):
    """Node records the kernel would read as float4 at an address that is
    not a multiple of 16 bytes raise before any launch."""
    pts, bvh = _tree(cuda, 1000, 4)
    r2 = torch.full((1000,), 0.02 ** 2, device=cuda)
    good = kw.pack_tree(bvh)

    def shifted(_bvh):
        out = []
        for t in good:
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            out.append(view)
        return kw.PackedTree(*out)

    monkeypatch.setattr(kw, "pack_tree", shifted)
    before = kw.wavefront_count.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kw.wavefront_count(bvh, pts, r2)
    offsets = torch.zeros(1001, dtype=torch.int32, device=cuda)
    offsets[-1] = 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        kw.wavefront_fill(bvh, pts, r2, offsets, 1)
    assert kw.wavefront_count.launches == before


def test_fdbscan_packs_its_tree_once(cuda, monkeypatch):
    """fdbscan's traversals (COUNT, every union round, the border pass)
    share one pack of the tree, and its result equals the CPU path's."""
    pts = make_clustered_points(np.random.default_rng(9), 20000)
    made = []
    real = kw.pack_tree

    def counting_pack(bvh):
        made.append(1)
        return real(bvh)

    monkeypatch.setattr(kw, "pack_tree", counting_pack)
    before = (kw.wavefront_count.launches, kw.wavefront_min_label.launches)
    got = fdbscan(pts, 0.01, 2, device=cuda)
    launches = (kw.wavefront_count.launches - before[0],
                kw.wavefront_min_label.launches - before[1])
    assert launches == (1, int(got.num_rounds) + 1) and made == [1]
    want = fdbscan(pts, 0.01, 2, device="cpu")
    for f in want._fields:
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=0, atol=0)


def stencil_cells(device, ncells, cap, d, seed, fill=0.6):
    """Slot-padded cells (ncells >= 5) with about ``fill`` of the slots
    occupied, padded slots anywhere in a cell and carrying random labels
    and core flags like every slot, the sink last; a stencil map of 27
    random ids, some of them the sink and some out of range (those read the
    sink too). Cell 0 is all padding, cell 1 all real, slot 0 of cell 2 a
    point whose coordinates are bitwise ``BIG``, and cells 3 to at most 10
    hold points a few ulps from ``BIG`` in about half their slots; the
    stencils of cells 0 to 10 start with cells 0 to 10."""
    rng = np.random.default_rng(seed)
    pts = np.full((ncells + 1, cap, d), kp.BIG, np.float32)
    occ = rng.random((ncells, cap)) < fill
    occ[0], occ[1], occ[2, 0] = False, True, False
    pts[:-1][occ] = rng.random((int(occ.sum()), d)).astype(np.float32) * 0.4
    big_bits = np.array(kp.BIG, np.float32).view(np.int32)
    for i in range(3, max(4, min(ncells - 1, 11))):
        near = rng.random(cap) < 0.5
        ulps = rng.integers(-3, 4, (int(near.sum()), d))
        pts[i, near] = (big_bits + ulps).astype(np.int32).view(np.float32)
    nbr = rng.integers(-3, ncells + 4, (ncells, 27)).astype(np.int32)
    k = min(ncells, 11)
    nbr[:k, :k] = np.arange(k)
    labels = rng.permutation((ncells + 1) * cap).astype(np.int32).reshape(ncells + 1, cap)
    core = rng.random((ncells + 1, cap)) < 0.5
    return [torch.from_numpy(a).to(device) for a in (pts, nbr, labels, core)]


def _stencil_matches_plain(cell_pts, nbr, labels, core, eps2):
    got = kp.stencil_count(cell_pts, nbr, eps2)
    torch.testing.assert_close(got, kp.stencil_count_plain(cell_pts, nbr, eps2),
                               rtol=0, atol=0)
    assert int(got.max()) > 0
    got = kp.stencil_min_label(cell_pts, labels, core, nbr, eps2)
    want = kp.stencil_min_label_plain(cell_pts, labels, core, nbr, eps2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(kp.slot_classes(cell_pts),
                               kp.slot_classes_plain(cell_pts), rtol=0, atol=0)


# d = 5: the kernel instance that reads coordinates at each use (D > 4).
@pytest.mark.parametrize("cap", [1, 4, 16, 48, 1100])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_stencil_kernels_match_plain(cuda, cap, d):
    cell_pts, nbr, labels, core = stencil_cells(cuda, 300 if cap < 1000 else 5, cap,
                                                d, cap + d)
    _stencil_matches_plain(cell_pts, nbr, labels, core, float(np.float32(0.15) ** 2))


@pytest.mark.parametrize("cap", [16, 48])
def test_stencil_kernels_at_grid_occupancy(cuda, cap):
    """``bin_points`` of uniform points with eps the mean spacing, as
    ``fdbscan_grid`` lays them out: a point a cell on average, random
    labels and core flags on the occupied slots."""
    n, eps = 1 << 15, 2.0 ** -5
    pts = torch.from_numpy(np.random.default_rng(cap).random((n, 3), dtype=np.float32))
    dims = tgrid.grid_dims_for(np.zeros(3), np.ones(3), eps)
    bins = tgrid.bin_points(pts.to(cuda), np.zeros(3, np.float32), eps, dims, cap)
    assert not bool(bins.overflowed)
    nbr = tgrid.stencil_neighbor_map(dims, device=cuda)
    rng = np.random.default_rng(cap + 1)
    slot = bins.slot_of_point.long()
    labels = tgrid._scatter_slots(
        torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda),
        kp.SENTINEL_LABEL, bins, slot)
    core = tgrid._scatter_slots(torch.from_numpy(rng.random(n) < 0.5).to(cuda),
                                False, bins, slot, dtype=torch.bool)
    _stencil_matches_plain(bins.cell_pts, nbr, labels, core, float(np.float32(eps) ** 2))


def test_stencil_launches_share_classes(cuda):
    """Inside ``shared_classes`` the launches on one ``cell_pts`` read one
    class mask; each launch still counts once."""
    cell_pts, nbr, labels, core = stencil_cells(cuda, 300, 16, 3, 5)
    eps2 = float(np.float32(0.15) ** 2)
    before = (kp.stencil_count.launches, kp.stencil_min_label.launches)
    with kp.shared_classes(cell_pts):
        first = kp._classes(cell_pts)
        got = kp.stencil_count(cell_pts, nbr, eps2)
        got_m = kp.stencil_min_label(cell_pts, labels, core, nbr, eps2)
        assert kp._classes(cell_pts) is first
    assert (kp.stencil_count.launches, kp.stencil_min_label.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, kp.stencil_count(cell_pts, nbr, eps2),
                               rtol=0, atol=0)
    torch.testing.assert_close(got_m, kp.stencil_min_label(cell_pts, labels, core,
                                                           nbr, eps2), rtol=0, atol=0)


# m and n off multiples of the 128-row tile and of 4, the empty cases; D
# below, at and past the 16-feature chunk, and one that does not divide it.
@pytest.mark.parametrize("m,n", [(1, 1), (129, 1000), (3001, 257), (0, 5), (7, 0),
                                 (1, 5000), (129, 257), (3001, 5003)])
@pytest.mark.parametrize("d", [1, 3, 64, 100, 257])
def test_pairwise_kernels_match_plain(cuda, m, n, d):
    rng = np.random.default_rng(m * 7 + n + d)
    x = torch.from_numpy(rng.random((m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((n, d)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.4).to(cuda)
    eps2 = float(np.float32(0.35 * d ** 0.5) ** 2)
    torch.testing.assert_close(kp.pairwise_count(x, y, eps2),
                               kp.pairwise_count_plain(x, y, eps2), rtol=0, atol=0)
    torch.testing.assert_close(kp.pairwise_min_label(x, y, labels, core, eps2),
                               kp.pairwise_min_label_plain(x, y, labels, core, eps2),
                               rtol=0, atol=0)


def test_pairwise_kernels_split_candidates(cuda):
    """m << n: 3 row tiles, so the candidate tiles are split across blocks
    and the parts meet in the output's atomics."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((300, 64)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((70_000, 64)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.permutation(70_000).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(70_000) < 0.4).to(cuda)
    eps2 = float(np.float32(2.6) ** 2)
    got = kp.pairwise_count(x, y, eps2)
    torch.testing.assert_close(got, kp.pairwise_count_plain(x, y, eps2), rtol=0, atol=0)
    assert 0 < int(got.min()) and int(got.max()) < 70_000
    torch.testing.assert_close(kp.pairwise_min_label(x, y, labels, core, eps2),
                               kp.pairwise_min_label_plain(x, y, labels, core, eps2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("d", [3, 64, 257])
def test_pairwise_kernels_exact_ties(cuda, d):
    """eps2 set to the plain version's own d2 of chosen pairs, so that
    d2 <= eps2 holds with equality there: a kernel that summed in another
    order or fused a multiply-add would move those pairs across eps."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.random((700, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((900, d)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.permutation(900).astype(np.int32)).to(cuda)
    core = torch.ones(900, dtype=torch.bool, device=cuda)
    d2 = kp._d2(x, kp._sq_norms(x), y, kp._sq_norms(y))
    for i, j in zip(rng.integers(0, 700, 8), rng.integers(0, 900, 8)):
        eps2 = float(d2[i, j])
        assert np.float32(eps2) == d2[i, j].item()   # the pair ties at eps
        torch.testing.assert_close(kp.pairwise_count(x, y, eps2),
                                   kp.pairwise_count_plain(x, y, eps2),
                                   rtol=0, atol=0)
        # The tie pair's own label is the row's min: the tie decides it.
        lab = labels.clone()
        lab[j] = -1
        got = kp.pairwise_min_label(x, y, lab, core, eps2)
        torch.testing.assert_close(got, kp.pairwise_min_label_plain(x, y, lab, core, eps2),
                                   rtol=0, atol=0)
        assert int(got[i]) == -1


def test_pairwise_launch_counters(cuda):
    x = torch.rand((10, 3), device=cuda)
    before = (kp.pairwise_count.launches, kp.pairwise_min_label.launches)
    kp.pairwise_count(x, x, 0.1)
    kp.pairwise_count(x[:0], x, 0.1)             # empty: nothing launched
    kp.pairwise_min_label(x, x, torch.zeros(10, dtype=torch.int32, device=cuda),
                          torch.ones(10, dtype=torch.bool, device=cuda), 0.1)
    assert (kp.pairwise_count.launches, kp.pairwise_min_label.launches) == \
        (before[0] + 1, before[1] + 1)


def test_fdbscan_grid_card_equals_cpu(cuda):
    pts = np.random.default_rng(21).uniform(0, 1, (20000, 3)).astype(np.float32)
    lo, eps = np.zeros(3, np.float32), 2.0 ** -5
    dims = tgrid.grid_dims_for(lo, np.ones(3), eps)
    before = (kp.stencil_count.launches, kp.stencil_min_label.launches)
    got, ovf = tgrid.fdbscan_grid(pts, eps, 5, scene_lo=lo, grid_dims=dims,
                                  capacity=16, device=cuda)
    rounds = int(got.num_rounds)
    assert (kp.stencil_count.launches, kp.stencil_min_label.launches) == \
        (before[0] + 1, before[1] + rounds + 1)
    want, want_ovf = tgrid.fdbscan_grid(pts, eps, 5, scene_lo=lo, grid_dims=dims,
                                        capacity=16, device="cpu")
    assert bool(ovf) == bool(want_ovf)
    for f in want._fields:
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=0, atol=0)


def _bits32(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _start_nodes(cuda, n_nodes, q, seed):
    """Random start nodes, internal nodes and leaves, a quarter SENTINEL."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, n_nodes, q).astype(np.int32)
    start[rng.random(q) < 0.25] = -1
    return torch.from_numpy(start).to(cuda)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ordered", [False, True])
def test_wavefront_potential_matches_plain(cuda, masked, ordered):
    """POTENTIAL bit-equal to its plain version, a self-join at two radii
    and off-tree queries with a radius each."""
    pts, bvh = _tree(cuda, 6000, 21)
    n = pts.shape[0]
    rng = np.random.default_rng(22 + masked)
    active = torch.from_numpy(rng.random(n) < 0.5).to(cuda) if masked else None
    order = bvh.leaf_perm if ordered else None
    for eps in (0.01, 0.04):
        r2 = torch.full((n,), eps, device=cuda) ** 2
        got = kw.wavefront_potential(bvh, pts, r2, (eps * 1e-2) ** 2, active,
                                     order=order)
        want = kw.wavefront_potential_plain(bvh, pts, r2, (eps * 1e-2) ** 2, active)
        assert torch.equal(_bits32(got), _bits32(want))
        if masked:
            assert not bool(got[~active].any())
    centers = torch.from_numpy(rng.uniform(-0.2, 1.2, (3000, 3)).astype(np.float32)).to(cuda)
    r2 = torch.from_numpy(rng.uniform(0, 0.05, 3000).astype(np.float32) ** 2).to(cuda)
    got = kw.wavefront_potential(bvh, centers, r2, 1e-7)
    want = kw.wavefront_potential_plain(bvh, centers, r2, 1e-7)
    assert torch.equal(_bits32(got), _bits32(want))


def test_inv_sqrt_sequence_matches_plain(cuda):
    """The kernel's 1/sqrt sequence against ``inv_sqrt_plain`` over every
    exponent of float32's positive normal range and subnormals."""
    rng = np.random.default_rng(23)
    bits = rng.integers(1, 0x7F800000, 1 << 22, dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(bits).view(torch.float32).to(cuda)
    assert torch.equal(_bits32(kw.inv_sqrt_rn(x)), _bits32(kw.inv_sqrt_plain(x)))


@pytest.mark.parametrize("stop_at", [None, 1, 4])
def test_wavefront_count_stats_match_plain(cuda, stop_at):
    """The counter instance: all six rows bit-equal to the plain counters,
    and the counts identical to the instance without counters."""
    from repro_torch.core.query import node_depths
    pts, bvh = _tree(cuda, 8000, 24)
    n = pts.shape[0]
    r2 = torch.from_numpy(np.random.default_rng(25).uniform(
        0, 0.04, n).astype(np.float32) ** 2).to(cuda)
    depths = node_depths(bvh)
    before = kw.wavefront_count.launches
    counts, stats = kw.wavefront_count(bvh, pts, r2, stop_at=stop_at,
                                       order=bvh.leaf_perm, depths=depths)
    assert kw.wavefront_count.launches == before + 1
    want_counts, want_stats = kw.wavefront_count_plain(bvh, pts, r2, stop_at,
                                                       depths=depths)
    assert stats.shape == (6, n) and stats.dtype == torch.int32
    assert torch.equal(counts, want_counts) and torch.equal(stats, want_stats)
    assert torch.equal(counts, kw.wavefront_count(bvh, pts, r2, stop_at=stop_at))
    assert torch.equal(stats[3], counts)


def test_every_instance_takes_start_nodes(cuda):
    """COUNT (with and without counters), MIN_LABEL, FILL, FIXED and
    POTENTIAL from random start nodes, a quarter of them SENTINEL, each
    bit-equal to its plain version, in a random thread order."""
    from repro_torch.core.query import node_depths
    pts, bvh = _tree(cuda, 5000, 26)
    n = q = pts.shape[0]
    rng = np.random.default_rng(27)
    r2 = torch.from_numpy(rng.uniform(0, 0.03, q).astype(np.float32) ** 2).to(cuda)
    order = torch.from_numpy(rng.permutation(q).astype(np.int32)).to(cuda)
    start = _start_nodes(cuda, 2 * n - 1, q, 28)
    idle = start == -1
    depths = node_depths(bvh)
    for stop in (None, 2):
        got = kw.wavefront_count(bvh, pts, r2, stop_at=stop, order=order, start=start)
        assert torch.equal(got, kw.wavefront_count_plain(bvh, pts, r2, stop, start))
        assert not bool(got[idle].any())
        got = kw.wavefront_count(bvh, pts, r2, stop_at=stop, order=order,
                                 start=start, depths=depths)
        want = kw.wavefront_count_plain(bvh, pts, r2, stop, start, depths)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not bool(got[1][:, idle].any())
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    mask = torch.from_numpy(rng.random(q) < 0.8).to(cuda)
    got = kw.wavefront_min_label(bvh, pts, r2, labels, core, mask, n, order=order,
                                 start=start)
    assert torch.equal(got, kw.wavefront_min_label_plain(bvh, pts, r2, labels, core,
                                                         mask, n, start))
    counts = kw.wavefront_count(bvh, pts, r2, start=start)
    for dtype, cut in ((torch.int32, 1), (torch.int32, 2), (torch.int64, 1)):
        offsets = _offsets(counts, dtype)
        cap = int(offsets[-1]) // cut
        got = kw.wavefront_fill(bvh, pts, r2, offsets, cap, order=order, start=start)
        assert torch.equal(got, kw.wavefront_fill_plain(bvh, pts, r2, offsets, cap,
                                                        start))
    for cap in (1, int(counts.max())):
        got = kw.wavefront_fixed(bvh, pts, r2, cap, order=order, start=start)
        want = kw.wavefront_fixed_plain(bvh, pts, r2, cap, start)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = kw.wavefront_potential(bvh, pts, r2, 1e-8, mask, order=order, start=start)
    want = kw.wavefront_potential_plain(bvh, pts, r2, 1e-8, mask, start)
    assert torch.equal(_bits32(got), _bits32(want))
    assert not bool(got[idle].any())


def test_all_sentinel_starts_walk_nothing(cuda):
    pts, bvh = _tree(cuda, 1000, 29)
    r2 = torch.full((1000,), 0.05 ** 2, device=cuda)
    start = torch.full((1000,), -1, dtype=torch.int32, device=cuda)
    assert not bool(kw.wavefront_count(bvh, pts, r2, start=start).any())
    assert not bool(kw.wavefront_potential(bvh, pts, r2, 1e-6, start=start).any())


def test_halo_products_card_equal_cpu(cuda):
    """The halo-products example's pipeline on the card against the CPU:
    labels, catalog integers, most-bound indices and potentials, and SO
    masses exact; one POTENTIAL launch and iters + 2 COUNT launches."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "halo_catalog_torch.py"
    spec = importlib.util.spec_from_file_location("halo_catalog_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    pts, vel, _, _ = ex.make_particles()
    got = ex.run(pts, vel, cuda)
    want = ex.run(pts, vel, "cpu")
    for g, w in zip(got, want):
        for f in w._fields:
            a, b = getattr(g, f).cpu(), getattr(w, f)
            if f in ("mass", "center", "vmean", "vdisp", "rmax"):
                # Catalog sums in the segment kernel's order.
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(_bits32(a), _bits32(b)), f
    before = (kw.wavefront_potential.launches, kw.wavefront_count.launches)
    from repro_torch.halos import most_bound_centers, so_masses
    cat = got[1]
    mb = most_bound_centers(pts, cat.particle_halo, ex.EPS * 2,
                            capacity=ex.CAPACITY, device=cuda)
    so_masses(pts, mb.center, cat.count > 0, r_max=0.1, iters=20, device=cuda)
    assert (kw.wavefront_potential.launches - before[0],
            kw.wavefront_count.launches - before[1]) == (1, 22)


# --- B1 (a)-(c): box and ray predicates, box leaves -------------------------

def _pred_trees(cuda, n, seed):
    """A point tree and a box-leaf tree over the same clustered points."""
    from repro_torch.core.bvh import build_bvh_objects
    pts, bvh = _tree(cuda, n, seed)
    rng = np.random.default_rng(seed + 1)
    h = torch.from_numpy(rng.uniform(0, 0.01, (n, 3)).astype(np.float32)).to(cuda)
    lo, hi = scene_bounds(pts)
    return pts, h, {"point": bvh, "box": build_bvh_objects(pts - h, pts + h, lo, hi)}


def _pred_geometry(cuda, pts, h, q, seed):
    """(qa, qb) per predicate: spheres, boxes (a quarter degenerate at
    points), rays (a quarter along z, some origins on leaf-box faces with
    a component in (-1e-12, 0): inverse +inf, NaN slabs)."""
    from repro_torch.core.geometry import safe_inv
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    c = t(rng.uniform(0, 1, (q, 3)))
    hw = t(rng.uniform(0, 0.05, (q, 3)))
    blo, bhi = c - hw, c + hw
    k = torch.from_numpy(rng.integers(0, pts.shape[0], q)).to(cuda)
    blo[: q // 4], bhi[: q // 4] = pts[k[: q // 4]], pts[k[: q // 4]]
    o = t(rng.uniform(0, 1, (q, 3)))
    o[1::5] = pts[k[1::5]]
    o[2::5] = (pts - h)[k[2::5]]
    d = t(rng.standard_normal((q, 3)))
    d[::4, :2] = 0.0
    d[2::5, 0] = -3e-13
    return {"sphere": (c, t(rng.uniform(0, 0.03, q)) ** 2), "box": (blo, bhi),
            "ray": (o, safe_inv(d))}


@pytest.mark.parametrize("leaf", ["point", "box"])
@pytest.mark.parametrize("pred", ["sphere", "box", "ray"])
def test_every_predicate_and_leaf_kind_matches_plain(cuda, leaf, pred):
    """COUNT (with and without counters and early exit), FILL (int32 and
    int64 offsets, exact and half capacity) and FIXED of each predicate on
    each leaf kind, from the root and from random start nodes: bit-equal
    to the plain versions."""
    pts, h, trees = _pred_trees(cuda, 5000, 71)
    bvh = trees[leaf]
    qa, qb = _pred_geometry(cuda, pts, h, 3000, 72)[pred]
    depths = tq.node_depths(bvh)
    before = kw.wavefront_count.instances[f"{pred}/{leaf}"]
    for start in (None, _start_nodes(cuda, 2 * 5000 - 1, 3000, 73)):
        for stop in (None, 3):
            got = kw.wavefront_count(bvh, qa, qb, pred=pred, stop_at=stop,
                                     start=start)
            want = kw.wavefront_count_plain(bvh, qa, qb, stop, start, pred=pred)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            got = kw.wavefront_count(bvh, qa, qb, pred=pred, stop_at=stop,
                                     start=start, depths=depths)
            want = kw.wavefront_count_plain(bvh, qa, qb, stop, start, depths,
                                            pred=pred)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        counts = kw.wavefront_count(bvh, qa, qb, pred=pred, start=start)
        for dtype in (torch.int32, torch.int64):
            offsets = _offsets(counts, dtype)
            for cap in (int(offsets[-1]), int(offsets[-1]) // 2):
                torch.testing.assert_close(
                    kw.wavefront_fill(bvh, qa, qb, offsets, cap, pred=pred,
                                      start=start),
                    kw.wavefront_fill_plain(bvh, qa, qb, offsets, cap, start,
                                            pred=pred), rtol=0, atol=0)
        for cap in (2, 64):
            for g, w in zip(kw.wavefront_fixed(bvh, qa, qb, cap, pred=pred,
                                               start=start),
                            kw.wavefront_fixed_plain(bvh, qa, qb, cap, start,
                                                     pred=pred)):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kw.wavefront_count.instances[f"{pred}/{leaf}"] == before + 10
    assert int(counts.sum()) > 0


def test_box_leaf_records_match_plain(cuda):
    """``pack_tree`` writes 32-byte leaf records for a box-leaf tree, bit
    for bit its plain version's, and 16-byte ones for a point tree."""
    _, _, trees = _pred_trees(cuda, 3000, 74)
    for leaf, bvh in trees.items():
        got, want = kw.pack_tree(bvh), kw.pack_tree_plain(bvh)
        assert got.leaves.shape[1] == (8 if leaf == "box" else 4)
        for f in got._fields:
            torch.testing.assert_close(getattr(got, f).view(torch.int32),
                                       getattr(want, f).view(torch.int32),
                                       rtol=0, atol=0)


def test_protocols_of_new_predicates_card_equal_cpu(cuda):
    """query_count (stackless and stack, with counters), query_csr and
    query_csr_buffered for boxes and rays on both trees: the card equals
    the CPU, and the stack backend launches no kernel."""
    pts, h, trees = _pred_trees(cuda, 4000, 75)
    geo = _pred_geometry(cuda, pts, h, 2000, 76)
    for leaf, bvh in trees.items():
        cpu_bvh = bvh._replace(**{f: getattr(bvh, f).cpu() for f in bvh._fields
                                  if isinstance(getattr(bvh, f), torch.Tensor)})
        preds = {"box": tq.intersects_box(*geo["box"]),
                 "ray": tq.ray(geo["ray"][0], geo["ray"][0] * 0 + 1)}
        for name, p in preds.items():
            cp = type(p)(*(x.cpu() for x in p))
            for backend in ("stackless", "stack"):
                launches = kw.wavefront_count.launches
                got = tq.query_count(bvh, p, backend=backend, with_stats=True)
                assert (kw.wavefront_count.launches - launches
                        == (backend == "stackless"))
                want = tq.query_count(cpu_bvh, cp, backend=backend, with_stats=True)
                torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
                for g, w in zip(got[1], want[1]):
                    torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
            for f, g in tq.query_csr(bvh, p, sort_queries=True)._asdict().items():
                torch.testing.assert_close(
                    g.cpu(), getattr(tq.query_csr(cpu_bvh, cp), f), rtol=0, atol=0)
            got = tq.query_csr_buffered(bvh, p, capacity=4)
            want = tq.query_csr_buffered(cpu_bvh, cp, capacity=4)
            assert got.attempts == want.attempts
            torch.testing.assert_close(got.indices.cpu(), want.indices, rtol=0, atol=0)


def test_min_label_and_potential_reject_box_leaves(cuda):
    pts, _, trees = _pred_trees(cuda, 1000, 77)
    bvh = trees["box"]
    r2 = torch.full((1000,), 0.01, device=cuda)
    ones = torch.ones(1000, dtype=torch.bool, device=cuda)
    labels = torch.arange(1000, dtype=torch.int32, device=cuda)
    before = (kw.wavefront_min_label.launches, kw.wavefront_potential.launches)
    with pytest.raises(ValueError, match="B1"):
        kw.wavefront_min_label(bvh, pts, r2, labels, ones, ones, 1000)
    with pytest.raises(ValueError, match="B1"):
        kw.wavefront_potential(bvh, pts, r2, 1e-6)
    assert (kw.wavefront_min_label.launches,
            kw.wavefront_potential.launches) == before


def test_fdbscan_stack_and_32bit_card_equal_cpu(cuda):
    """fdbscan with the stack backend (its count pass in torch ops on the
    card) and over 30-bit codes: the card equals the CPU."""
    pts = make_clustered_points(np.random.default_rng(78), 8000)
    for kwargs in ({"use_stack": True}, {"use_stack": True, "early_stop": False},
                   {"use_64bit": False}):
        got = fdbscan(pts, 0.01, 3, device=cuda, **kwargs)
        want = fdbscan(pts, 0.01, 3, device="cpu", **kwargs)
        for f in want._fields:
            torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                       rtol=0, atol=0)


# --- The pair and DenseBox epilogues (EDGE, HISTOGRAM, DENSE_*) ------------

def _pair_inputs(cuda, n, seed, eps):
    pts, bvh = _tree(cuda, n, seed)
    perm = bvh.leaf_perm.long()
    r2 = torch.full((n,), eps, dtype=torch.float32, device=cuda) ** 2
    return bvh, pts[perm].contiguous(), r2, kw.pair_starts(bvh)


@pytest.mark.parametrize("capacity", [1, 2, 8])
def test_wavefront_edge_matches_plain(cuda, capacity):
    n = 6000
    bvh, centers, r2, starts = _pair_inputs(cuda, n, 81, 0.03)
    rng = np.random.default_rng(capacity)
    core = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    parent = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(cuda)
    keys = kw.pair_keys(bvh, parent, core)
    before = kw.wavefront_edge.launches
    got = kw.wavefront_edge(bvh, centers, r2, keys, capacity, start=starts)
    assert kw.wavefront_edge.launches == before + 1
    want = kw.wavefront_edge_plain(bvh, centers, r2, keys, capacity, starts)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert int(want[1].max()) == capacity


@pytest.mark.parametrize("n_bins", [1, 16, 1000, kw.SHARED_HISTOGRAM_BINS,
                                    kw.SHARED_HISTOGRAM_BINS + 1, 10000])
def test_wavefront_histogram_matches_plain(cuda, n_bins):
    """Bins in a block's shared memory and, past SHARED_HISTOGRAM_BINS,
    in global memory, against the plain version."""
    n = 6000
    bvh, centers, r2, starts = _pair_inputs(cuda, n, 82, 0.1)
    got = kw.wavefront_histogram(bvh, centers, r2, 0.1, n_bins, start=starts)
    want = kw.wavefront_histogram_plain(bvh, centers, r2, 0.1, n_bins, starts)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # Every query from the root: each ordered pair and each point itself.
    all_pairs = kw.wavefront_histogram(bvh, centers, r2, 0.1, n_bins)
    assert int(all_pairs.sum()) == 2 * int(got.sum()) + n


@pytest.mark.parametrize("side", ["keys", "words", "pts", "scan_lab", "qmask"])
def test_side_tensors_on_the_host_raise(cuda, side):
    """A side tensor left on the host next to queries on the card raises
    ValueError, before any host pointer reaches the kernel."""
    from repro_torch.core.dbscan import densebox_tree
    n = 500
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(85), n)).to(cuda)
    t = densebox_tree(pts, 0.05, 3)
    args = {"keys": torch.zeros((n, 2), dtype=torch.int32, device=cuda),
            "words": t.words(torch.zeros(n, dtype=torch.int32, device=cuda)),
            "pts": t.pts_sorted, "scan_lab": torch.zeros(n, dtype=torch.int32, device=cuda),
            "qmask": torch.ones(n, dtype=torch.bool, device=cuda)}
    args[side] = args[side].cpu()
    before = kw.wavefront_edge.launches + kw.wavefront_dense_min_label.launches
    with pytest.raises(ValueError, match="device"):
        if side == "keys":
            bvh, centers, r2, starts = _pair_inputs(cuda, n, 86, 0.05)
            kw.wavefront_edge(bvh, centers, r2, args["keys"], 2, start=starts)
        else:
            kw.wavefront_dense_min_label(t.bvh, t.pts_sorted, t.r2, args["words"],
                                         args["pts"], args["scan_lab"], t.half,
                                         args["qmask"], n)
    assert kw.wavefront_edge.launches + kw.wavefront_dense_min_label.launches == before


def test_histogram_bin_sequence_matches_plain(cuda):
    """HISTOGRAM's bin sequence on 2^22 squared distances, subnormal ones
    and ones at bin edges included."""
    rng = np.random.default_rng(3)
    d = rng.random(1 << 22).astype(np.float32) * 0.2
    edges = (np.arange(17, dtype=np.float32) * np.float32(0.2 / 16)) ** 2
    d2 = np.concatenate([d * d, edges, np.nextafter(edges, 1), np.nextafter(edges, 0),
                         np.array([1e-40, 0.0, 1e-31], np.float32)])
    x = torch.from_numpy(d2).to(cuda)
    torch.testing.assert_close(kw.histogram_bins_rn(x, 0.2, 16).cpu(),
                               kw.histogram_bins(x.cpu(), 0.2, 16), rtol=0, atol=0)


@pytest.mark.parametrize("eps,min_pts", [(0.02, 2), (0.05, 5), (0.1, 20)])
def test_wavefront_dense_matches_plain(cuda, eps, min_pts):
    """Both DenseBox epilogues on a mixed tree of cells, skipped points and
    loose points, with whole and partial cells."""
    from repro_torch.core.dbscan import densebox_tree
    n = 6000
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(83), n)).to(cuda)
    t = densebox_tree(pts, eps, min_pts)
    assert bool((t.kind == kw.DENSE_CELL).any()) and bool((t.kind == kw.DENSE_POINT).any())
    rng = np.random.default_rng(min_pts)
    lab = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    words = t.words(lab)
    for stop in (None, min_pts):
        got = kw.wavefront_dense_count(t.bvh, t.pts_sorted, t.r2, words, t.pts_sorted,
                                       t.half, stop_at=stop, qmask=~t.dense,
                                       order=t.bvh.leaf_perm)
        want = kw.wavefront_dense_count_plain(t.bvh, t.pts_sorted, t.r2, words,
                                              t.pts_sorted, t.half, stop, ~t.dense)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    qmask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    got = kw.wavefront_dense_min_label(t.bvh, t.pts_sorted, t.r2, words, t.pts_sorted,
                                       lab, t.half, qmask, n, order=t.bvh.leaf_perm)
    want = kw.wavefront_dense_min_label_plain(t.bvh, t.pts_sorted, t.r2, words,
                                              t.pts_sorted, lab, t.half, qmask, n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pair_and_densebox_card_equal_cpu(cuda):
    """fdbscan_pair, fdbscan_densebox and pair_count_histogram on the card
    against the CPU path, exactly, each launching its kernels."""
    from repro_torch.core import correlation as tc
    from repro_torch.core import dbscan as td
    pts = make_clustered_points(np.random.default_rng(84), 1 << 14)
    for fn, kwargs in ((td.fdbscan_pair, {"edge_capacity": 2}),
                       (td.fdbscan_densebox, {})):
        a = fn(pts, 0.02, 5, device="cuda", **kwargs)
        b = fn(pts, 0.02, 5, device="cpu", **kwargs)
        for f in a._fields:
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), rtol=0, atol=0)
    before = kw.wavefront_histogram.launches
    got = tc.pair_count_histogram(pts, 0.05, 16, device="cuda")
    assert kw.wavefront_histogram.launches == before + 1
    torch.testing.assert_close(got.cpu(), tc.pair_count_histogram(pts, 0.05, 16,
                                                                  device="cpu"),
                               rtol=0, atol=0)


# --- C7: the stencil and all-pairs kernels flush subnormals ----------------

def _subnormal_rows(rng, m, d):
    """Rows mixing subnormal, tiny normal and ordinary coordinates, so that
    products and differences fall below FLT_MIN."""
    x = rng.random((m, d)).astype(np.float32)
    pick = rng.random((m, d))
    x[pick < 0.3] = rng.choice(np.array([1e-20, -1e-20, 3e-39, -5e-40, 1e-45, 2e-19],
                                        np.float32), int((pick < 0.3).sum()))
    x[pick > 0.9] = 0.0
    return x


@pytest.mark.parametrize("d", [1, 3, 64])
def test_pairwise_kernels_flush_subnormals(cuda, d):
    rng = np.random.default_rng(d + 100)
    x = torch.from_numpy(_subnormal_rows(rng, 300, d)).to(cuda)
    y = torch.from_numpy(_subnormal_rows(rng, 500, d)).to(cuda)
    labels = torch.from_numpy(rng.permutation(500).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(500) < 0.5).to(cuda)
    for eps2 in (0.0, float(np.float32(0.3 * d ** 0.5) ** 2)):
        torch.testing.assert_close(kp.pairwise_count(x, y, eps2),
                                   kp.pairwise_count_plain(x, y, eps2), rtol=0, atol=0)
        torch.testing.assert_close(kp.pairwise_min_label(x, y, labels, core, eps2),
                                   kp.pairwise_min_label_plain(x, y, labels, core, eps2),
                                   rtol=0, atol=0)
    # The C7 case: (1e-20, 0, 0) against the origin at eps = 0 is a hit.
    a = torch.tensor([[1e-20, 0.0, 0.0]], device=cuda)
    o = torch.zeros((1, 3), device=cuda)
    assert int(kp.pairwise_count(a, o, 0.0)[0]) == 1


@pytest.mark.parametrize("cap", [4, 16])
def test_stencil_kernels_flush_subnormals(cuda, cap):
    cell_pts, nbr, labels, core = stencil_cells(cuda, 300, cap, 3, cap + 50)
    rng = np.random.default_rng(cap)
    real = (cell_pts != kp.BIG).all(-1)
    tiny = torch.from_numpy(_subnormal_rows(rng, int(real.sum()), 3) * 1e-3).to(cuda)
    cell_pts[real] = tiny
    for eps2 in (0.0, 1e-6):
        _stencil_matches_plain(cell_pts, nbr, labels, core, eps2)


# --- B1 (e): MIN_LABEL over int64 labels; the sharded path ------------------

@pytest.mark.parametrize("offset", [0, 2**32, 2**40 + 3])
def test_wavefront_min_label_int64_matches_plain(cuda, offset):
    """The int64 instance against its plain version, bit for bit, with
    labels whose high word matters; and equal to the int32 instance's
    result plus the offset."""
    pts, bvh = _tree(cuda, 5000, 3)
    n = pts.shape[0]
    rng = np.random.default_rng(11)
    r2 = torch.full((n,), 0.012 ** 2, device=cuda)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    core = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    wide = labels.long() + offset
    before = kw.wavefront_min_label.instances["sphere/point/int64"]
    for mask in (core, ~core):
        got = kw.wavefront_min_label(bvh, pts, r2, wide, core, mask, n + offset,
                                     order=bvh.leaf_perm)
        assert got.dtype == torch.int64
        want = kw.wavefront_min_label_plain(bvh, pts, r2, wide, core, mask,
                                            n + offset)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        narrow = kw.wavefront_min_label(bvh, pts, r2, labels, core, mask, n,
                                        order=bvh.leaf_perm)
        torch.testing.assert_close(got, narrow.long() + offset, rtol=0, atol=0)
    assert kw.wavefront_min_label.instances["sphere/point/int64"] == before + 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_dbscan_distributed_on_four_shards_equals_fdbscan(cuda, dtype):
    """dbscan_distributed on 4 shards of the card: labels and core mask of
    fdbscan, and the CPU mesh's rounds, launching MIN_LABEL's instance of
    the label dtype."""
    from repro_torch.core import ShardMesh, dbscan_distributed, slab_partition
    pts, _ = slab_partition(make_clustered_points(np.random.default_rng(21),
                                                  1 << 14), 4)
    key = "sphere/point/int64" if dtype == torch.int64 else "sphere/point"
    before = kw.wavefront_min_label.instances[key]
    # A ghost buffer of a whole slab cannot overflow.
    got = dbscan_distributed(pts, 0.01, 2, mesh=ShardMesh(4, cuda),
                             halo_cap=1 << 12, index_dtype=dtype)
    assert kw.wavefront_min_label.instances[key] > before
    assert not bool(got.halo_overflow) and got.labels.dtype == dtype
    single = fdbscan(pts, 0.01, 2, device=cuda)
    torch.testing.assert_close(got.labels.int(), single.labels, rtol=0, atol=0)
    torch.testing.assert_close(got.core_mask, single.core_mask, rtol=0, atol=0)
    cpu = dbscan_distributed(pts, 0.01, 2, mesh=ShardMesh(4, "cpu"),
                             halo_cap=1 << 12, index_dtype=dtype)
    for f in got._fields:
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(cpu, f),
                                   rtol=0, atol=0)


def test_first_kernel_use_from_four_threads(cuda, monkeypatch):
    """Four threads that first use a kernel at once, with its library
    stale: one nvcc, one load, every launch counted, every result right."""
    import os
    import subprocess
    import threading
    from repro_torch.kernels import _build

    _build.build_all(("segment",))
    so = _build.BUILD_DIR / "segment.so"
    os.utime(so, (0, 0))                       # older than its source: stale
    started = []
    real_popen = subprocess.Popen

    def popen(cmd, *a, **k):
        started.append(cmd)
        return real_popen(cmd, *a, **k)

    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    _build._load.cache_clear()
    ks._lib.cache_clear()
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(np.sort(rng.integers(0, 50, 10_000)).astype(np.int32)).to(cuda)
    data = torch.from_numpy(rng.standard_normal((10_000, 8), np.float32)).to(cuda)
    want = ks.segment_max_sorted_plain(data, ids, 50)
    before = ks.segment_max_sorted.launches
    outs, errors = [], []

    def use():
        try:
            outs.append(ks.segment_max_sorted(data, ids, 50))
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(started) == 1 and "segment.cu" in started[0][-1]
    assert ks.segment_max_sorted.launches == before + 4
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The nearest kernel (csrc/nearest.cu): KNN, EMST and RAY against their plain
# versions, bit for bit, pops included.
# ---------------------------------------------------------------------------

def _same_bits(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 4, 16, 33, 64])
def test_nearest_knn_matches_plain(cuda, k):
    """k = 33 and 64 are past the local-memory buffer (LOCAL_K)."""
    from repro_torch.kernels import nearest as kn
    pts, bvh = _tree(cuda, 5000, k)
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.uniform(-0.1, 1.1, (777, 3)).astype(np.float32)).to(cuda)
    before = kn.nearest_knn.launches
    _same_bits(kn.nearest_knn(bvh, q, k, with_pops=True),
               kn.nearest_knn_plain(bvh, q, k, True))
    _same_bits(kn.nearest_knn(bvh, pts, k, order=bvh.leaf_perm),
               kn.nearest_knn_plain(bvh, pts, k))
    assert kn.nearest_knn.launches == before + 2


def test_nearest_knn_exact_ties_keep_slot_order(cuda):
    from repro_torch.kernels import nearest as kn
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3), -1).reshape(-1, 3) / 8
    pts = torch.from_numpy(np.concatenate([g, g]).astype(np.float32)).to(cuda)
    bvh = build_bvh(pts, *scene_bounds(pts))
    for k in (7, 45):
        _same_bits(kn.nearest_knn(bvh, pts, k, with_pops=True),
                   kn.nearest_knn_plain(bvh, pts, k, True))


@pytest.mark.parametrize("n_comp", [1, 64, 5000])
def test_nearest_other_component_matches_plain(cuda, n_comp):
    from repro_torch.kernels import nearest as kn
    temst = importlib.import_module("repro_torch.core.emst")
    pts, bvh = _tree(cuda, 5000, n_comp)
    comp = (torch.arange(5000, dtype=torch.int32, device=cuda) if n_comp == 5000
            else torch.from_numpy(np.random.default_rng(n_comp).integers(
                0, n_comp, 5000).astype(np.int32)).to(cuda))
    clo, chi = temst._node_component_intervals(bvh, comp[bvh.leaf_perm.long()])
    iv = torch.stack([clo, chi], 1)
    before = kn.nearest_other_component.launches
    _same_bits(kn.nearest_other_component(bvh, pts, comp, comp, iv,
                                          order=bvh.leaf_perm, with_pops=True),
               kn.nearest_other_component_plain(bvh, pts, comp, comp, iv, True))
    assert kn.nearest_other_component.launches == before + 1


@pytest.mark.parametrize("boxes", [False, True])
def test_nearest_ray_matches_plain(cuda, boxes):
    from repro_torch.core.bvh import build_bvh_objects
    from repro_torch.core.geometry import safe_inv
    from repro_torch.kernels import nearest as kn
    pts, bvh = _tree(cuda, 5000, 11)
    if boxes:
        bvh = build_bvh_objects(pts - 0.004, pts + 0.004, *scene_bounds(pts))
    rng = np.random.default_rng(12)
    o = torch.from_numpy(rng.uniform(-0.2, 1.2, (1000, 3)).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.standard_normal((1000, 3)).astype(np.float32)).to(cuda)
    d[::9, :2] = 0.0
    d[1::13, 0] = -1e-13
    o[::17] = pts[:o[::17].shape[0]]
    inv = safe_inv(d)
    _same_bits(kn.nearest_ray(bvh, o, inv, with_pops=True),
               kn.nearest_ray_plain(bvh, o, inv, True))


def test_assert_no_host_transfers_on_the_card(cuda):
    """The run-time guard: the device CSR runs clean under the card's
    sync guard (and the mode's host-to-device check); a scalar read and
    a copy of a Python number to the card each raise."""
    from repro_torch.staticcheck import assert_no_host_transfers
    pts, bvh = _tree(cuda, 4000, 14)
    pred = tq.within(pts, 0.02)
    total = int(tq.query_count(bvh, pred).sum())
    for guard in ("all", "d2h"):
        res = assert_no_host_transfers(
            lambda b, p: tq.query_csr_device(b, p, total + 64), bvh, pred,
            guard=guard)
        assert int(res.total) == total and not bool(res.overflowed)
    with pytest.raises(RuntimeError):
        assert_no_host_transfers(lambda a: a * float(a.sum()), pts)
    with pytest.raises(RuntimeError):
        assert_no_host_transfers(
            lambda a: a + torch.tensor(0.5, device=a.device), pts)


def test_sync_rule_counts_what_the_card_warns(cuda):
    """The dispatch rule's host syncs equal the card's sync warnings, op
    by op and line by line, on a whole ``fdbscan`` (its tree build, union
    rounds and constants from the host)."""
    from repro_torch.staticcheck import sync_warnings
    pts = torch.from_numpy(make_clustered_points(np.random.default_rng(15), 2000)).to(cuda)
    fdbscan(pts, 0.02, 2, device=cuda)
    rep = sync_warnings(lambda p: fdbscan(p, 0.02, 2, device=cuda), pts)
    assert rep["counted"] == rep["warned"] > 0 and not rep["differ"]
