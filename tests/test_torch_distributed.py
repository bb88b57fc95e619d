"""The sharded layer (``repro_torch.core.distributed`` on the in-process
``ShardMesh``) against the JAX reference's ``shard_map`` layer.

The reference needs a multi-device mesh, so it runs once per module in a
subprocess with ``--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` does) and hands its arrays back as ``.npz``;
the port runs in this process on S ∈ {1, 2, 4} shards of the CPU.
Labels, core mask, rounds and the overflow flag must match exactly, at
int32 and int64 global ids; the CSR rows match as sets (the fold of
invalid ghost rows may differ by an ulp under XLA's contraction, ROADMAP
C8, which moves the trees but no ε-hit).
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_clustered_points  # noqa: E402
from repro_torch.core import (ShardMesh, dbscan_distributed, fdbscan,  # noqa: E402
                              halo_exchange, query_count, sharded_neighbor_csr,
                              slab_partition, within)
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import MetricsRegistry, TraversalStats  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
N, EPS = 512, 0.05
CSR_EPS = 0.12

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, {tests!r})
    from conftest import make_clustered_points
    from repro.core.distributed import (dbscan_distributed,
                                        sharded_neighbor_csr, slab_partition)

    out = {{}}
    pts = make_clustered_points(np.random.default_rng(7), {n})
    pts, _ = slab_partition(pts, 4)
    jp = jnp.asarray(pts)
    out["pts"] = pts
    mesh = {{s: Mesh(np.array(jax.devices()[:s]), ("data",)) for s in (1, 2, 4)}}

    def keep(key, res):
        for f in res._fields:
            out[key + "/" + f] = np.asarray(getattr(res, f))

    for s in (1, 2, 4):
        keep(f"db/{{s}}/int32", dbscan_distributed(jp, {eps}, 2, mesh=mesh[s]))
        with jax.enable_x64(True):
            keep(f"db/{{s}}/int64", dbscan_distributed(
                jp, {eps}, 2, mesh=mesh[s], index_dtype=jnp.int64))
    keep("db5", dbscan_distributed(jp, {eps}, 5, mesh=mesh[4]))
    keep("small_cap", dbscan_distributed(jp, {eps}, 2, mesh=mesh[4], halo_cap=8))
    x = np.linspace(0.01, 0.99, {n}).astype(np.float32)
    line = np.stack([x, np.full({n}, .5, np.float32),
                     np.full({n}, .5, np.float32)], 1)
    out["line"] = line
    keep("line", dbscan_distributed(jnp.asarray(line), 0.01, 2, mesh=mesh[4],
                                    halo_cap=64))
    keep("csr/4/int32", sharded_neighbor_csr(jp, {csr_eps}, capacity=40000,
                                             mesh=mesh[4], halo_cap=128))
    with jax.enable_x64(True):
        keep("csr/2/int64", sharded_neighbor_csr(
            jp, {csr_eps}, capacity=40000, mesh=mesh[2], halo_cap=128,
            index_dtype=jnp.int64))
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_distributed") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(TESTS), "src")
    env.pop("XLA_FLAGS", None)
    code = SCRIPT.format(tests=TESTS, n=N, eps=EPS, csr_eps=CSR_EPS, path=path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _assert_same(got, ref, key):
    """Every field of a port result equal to the reference's, dtype too."""
    for f in got._fields:
        want = ref[f"{key}/{f}"]
        g = getattr(got, f).numpy()
        assert g.dtype == want.dtype, (f, g.dtype, want.dtype)
        np.testing.assert_array_equal(g, want, err_msg=f"{key}/{f}")


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_dbscan_distributed_matches_reference(ref, shards, dtype):
    """Exact: labels (global ids of the dtype), core mask, rounds and the
    halo overflow flag; the labels are also the port's ``fdbscan`` labels
    on the slab-sorted cloud."""
    pts = ref["pts"]
    got = dbscan_distributed(pts, EPS, 2, mesh=ShardMesh(shards, "cpu"),
                             index_dtype=getattr(torch, dtype))
    _assert_same(got, ref, f"db/{shards}/{dtype}")
    single = fdbscan(pts, EPS, 2, device="cpu")
    assert torch.equal(got.labels.to(torch.int32), single.labels)
    assert torch.equal(got.core_mask, single.core_mask)


@pytest.mark.parametrize("case", ["min_pts_5", "small_halo_cap", "line"])
def test_dbscan_distributed_cases_match_reference(ref, case):
    """min_pts 5; a halo buffer of 8 rows that overflows (the flag and the
    labels it then gives, exactly as the reference's); a filament crossing
    every slab, which must merge into one cluster."""
    mesh = ShardMesh(4, "cpu")
    if case == "min_pts_5":
        got, key = dbscan_distributed(ref["pts"], EPS, 5, mesh=mesh), "db5"
    elif case == "small_halo_cap":
        got = dbscan_distributed(ref["pts"], EPS, 2, mesh=mesh, halo_cap=8)
        key = "small_cap"
        assert bool(got.halo_overflow)
    else:
        got = dbscan_distributed(ref["line"], 0.01, 2, mesh=mesh, halo_cap=64)
        key = "line"
        assert (got.labels == got.labels[0]).all() and got.labels[0] >= 0
    _assert_same(got, ref, key)


@pytest.mark.parametrize("shards,dtype", [(4, "int32"), (2, "int64")])
def test_sharded_neighbor_csr_matches_reference(ref, shards, dtype):
    """Per shard and row, the same global ids as a set (each row's own
    order follows its tree); offsets, totals and the overflow flag
    exact."""
    key = f"csr/{shards}/{dtype}"
    got = sharded_neighbor_csr(ref["pts"], CSR_EPS, capacity=40000,
                               mesh=ShardMesh(shards, "cpu"), halo_cap=128,
                               index_dtype=getattr(torch, dtype))
    for f in ("offsets", "total", "overflowed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      ref[f"{key}/{f}"], err_msg=f)
    assert got.indices.dtype == getattr(torch, dtype)
    offs, idx, want_idx = got.offsets.numpy(), got.indices.numpy(), \
        ref[f"{key}/indices"]
    for s in range(shards):
        for q in range(offs.shape[1] - 1):
            row = slice(offs[s, q], offs[s, q + 1])
            np.testing.assert_array_equal(np.sort(idx[s, row]),
                                          np.sort(want_idx[s, row]))
    # and the rows are the brute-force ε-graph
    pts = ref["pts"]
    adj = ((pts[:, None] - pts[None]) ** 2).sum(-1) <= CSR_EPS ** 2
    assert int(got.total.sum()) == int(adj.sum())


def _run(mesh, body, *args):
    return mesh.run(body, *[torch.as_tensor(a) for a in args])


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_halo_exchange_edges_receive_nothing(shards):
    """The slab-edge shards receive no ghosts from outside the mesh
    (zeros decode as absent); every valid ghost is a neighbour's boundary
    point with its global id; invalid ghost rows lie ≥ 4ε outside."""
    pts = np.sort(np.random.default_rng(3).uniform(0, 1, (96, 3)), 0) \
        .astype(np.float32)
    mesh = ShardMesh(shards, "cpu")
    n_loc = len(pts) // shards

    def body(axis, p):
        gid = axis.index * n_loc + torch.arange(n_loc, dtype=torch.int64)
        return halo_exchange(p, gid, 0.1, 16, axis)

    for k, ex in enumerate(_run(mesh, body, pts)):
        local = pts[k * n_loc:(k + 1) * n_loc]
        h = ex.halo_valid.shape[0] // 2
        assert not ex.halo_valid[:h].any() if k == 0 else ex.halo_valid[:h].any()
        assert not ex.halo_valid[h:].any() if k == shards - 1 \
            else ex.halo_valid[h:].any()
        v = ex.halo_valid
        gid = ex.halo_gid[v].numpy()
        assert ((gid // n_loc == k - 1) | (gid // n_loc == k + 1)).all()
        np.testing.assert_array_equal(ex.halo_pts[v].numpy(), pts[gid])
        assert (ex.halo_gid[~v] == -1).all()
        seen = np.concatenate([local, ex.halo_pts[v].numpy()]).max(0)
        assert (ex.halo_pts[~v].numpy() >= seen + 0.4 - 1e-6).all()


@pytest.mark.parametrize("collective", ["ppermute", "psum", "pmax",
                                        "all_gather"])
def test_mesh_collectives(collective):
    """Each collective on 3 shards: ppermute along the right route, the
    left edge receiving zeros; sums and maxima the same on every shard."""
    mesh = ShardMesh(3, "cpu")
    vals = torch.tensor([[1, 5], [4, 2], [3, 3]], dtype=torch.int64)

    def body(axis, v):
        v = v[0]
        if collective == "ppermute":
            return axis.ppermute(v, [(0, 1), (1, 2)])
        return getattr(axis, collective)(v)

    got = _run(mesh, body, vals)
    want = {"ppermute": [[0, 0], [1, 5], [4, 2]],
            "psum": [[8, 10]] * 3, "pmax": [[4, 5]] * 3,
            "all_gather": [vals.tolist()] * 3}[collective]
    assert [g.tolist() for g in got] == want


@pytest.mark.parametrize("failing", [0, 2])
def test_mesh_error_in_one_shard_raises_in_caller(failing):
    """The failing shard's own error reaches the caller, at once: the other
    shards stop waiting at the collective instead of timing out."""
    mesh = ShardMesh(3, "cpu", timeout=60.0)

    def body(axis, v):
        if axis.index == failing:
            raise KeyError("boom")
        return axis.psum(v)

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="boom"):
        _run(mesh, body, torch.zeros(3))
    assert time.perf_counter() - t0 < 30.0
    again = _run(mesh, lambda axis, v: axis.psum(v), torch.ones(3))
    assert [t.tolist() for t in again] == [[3.0]] * 3


def test_mesh_timeout_on_a_missed_collective():
    """A shard that skips a collective its peers wait at ends the run with
    an error after the timeout, not a hang."""
    mesh = ShardMesh(2, "cpu", timeout=0.5)

    def body(axis, v):
        if axis.index == 0:
            return axis.psum(v)
        return v

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not all reach it"):
        _run(mesh, body, torch.zeros(2))
    assert time.perf_counter() - t0 < 30.0


def test_mesh_rejects_a_ragged_split():
    with pytest.raises(ValueError, match="divisible"):
        ShardMesh(3, "cpu").split(torch.zeros(10, 3))


def test_traversal_stats_psum_is_the_sum_over_shards():
    """``TraversalStats.psum``: counters summed over the shards, max_depth
    their maximum, early_exits each shard's own."""
    pts = make_clustered_points(np.random.default_rng(5), 300)
    queries = torch.from_numpy(pts[:40])
    trees = [build_bvh(p, *scene_bounds(p))
             for p in torch.from_numpy(pts).chunk(3)]
    per_shard = [query_count(t, within(queries, 0.05), stop_at=4,
                             with_stats=True)[1] for t in trees]

    def body(axis, _):
        return per_shard[axis.index].psum(axis)

    got = _run(ShardMesh(3, "cpu"), body, torch.zeros(3))
    for k, st in enumerate(got):
        for f in TraversalStats._fields:
            cols = torch.stack([getattr(s, f) for s in per_shard])
            want = {"early_exits": cols[k], "max_depth": cols.amax(0)}.get(
                f, cols.sum(0))
            assert torch.equal(getattr(st, f), want), f


def test_registry_observes_sharded_results():
    """``MetricsRegistry.observe`` of a ``ShardedCsr`` (per-shard totals)
    and of each shard's ``HaloExchange``."""
    pts, _ = slab_partition(
        make_clustered_points(np.random.default_rng(6), 256), 2)
    mesh = ShardMesh(2, "cpu")
    csr = sharded_neighbor_csr(pts, 0.05, capacity=20000, mesh=mesh,
                               halo_cap=64)
    exchanges = _run(mesh, lambda axis, p: halo_exchange(
        p, torch.arange(128) + 128 * axis.index, 0.05, 64, axis), pts)
    reg = MetricsRegistry()
    reg.observe("csr", csr)
    for ex in exchanges:
        reg.observe("halo", ex)
    s = reg.summary()
    assert s["csr/total"]["count"] == 2
    assert s["csr/total"]["sum"] == float(csr.total.sum())
    assert s["halo/ghost_rows"]["sum"] == float(
        sum(int(ex.halo_valid.sum()) for ex in exchanges))
    assert s["halo/payload_bytes"]["last"] == 128 * 12 + 128 * 8
    assert s["halo/overflowed"]["max"] == 0.0


def test_launch_counter_and_build_are_thread_safe(monkeypatch):
    """Eight threads that count launches at once, with the interpreter
    switching threads every microsecond, lose no count; four threads that
    first ask for one library at once build and load it once."""
    def fake(): pass
    fake.launches = 0
    fake.instances = __import__("collections").Counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(fake, 1, "sphere/point") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fake.launches == 16000 and fake.instances["sphere/point"] == 16000

    builds, loaded = [], []

    def slow_build(names):
        builds.append(names)
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path)
                        or object())
    _build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(
            _build.library("wavefront"))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        _build._load.cache_clear()
    assert not any(t.is_alive() for t in threads)
    assert builds == [("wavefront",)] and len(loaded) == 1
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
