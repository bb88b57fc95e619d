"""The sharded catalog merge and halo pipeline (``repro_torch.halos.merge``
on the in-process ``ShardMesh``) against the JAX reference's, and the
catalog's int64 labels (ROADMAP C10).

The reference's mesh runs once per module in a subprocess with
``--xla_force_host_platform_device_count=4`` and hands its arrays back as
``.npz``; the port runs in this process on S ∈ {1, 2, 4} shards of the
CPU. Labels, core mask, rounds, overflow flags and the catalogs' integers
(``num_halos``, ``root``, ``count``, ``particle_halo``) must match
exactly, at int32 and int64 global ids; float sums within ``FLOAT_TOL``
(float32 sums taken in another order); SO masses exactly, as in
``tests/test_torch_so_mass.py``.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.halos import catalog as jax_catalog  # noqa: E402
from repro.halos import merge as jax_merge  # noqa: E402
from repro.kernels.segment import SEG_NEG_BIG  # noqa: E402
from repro_torch.core import ShardMesh, fdbscan, slab_partition  # noqa: E402
from repro_torch.halos import (finalize_rmax, halo_catalog,  # noqa: E402
                               halo_catalog_sharded, halo_pipeline_sharded,
                               halo_pipeline_traced, local_rmax2,
                               merge_partial_catalogs, partial_catalog,
                               particle_slots)
from repro_torch.obs import SpanTracer  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
N, EPS, CAP, MIN_COUNT = 512, 0.05, 128, 5
SO = dict(so_delta=200.0, so_r_max=0.1)
INT_FIELDS = ("num_halos", "overflow", "root", "count", "particle_halo")
FLOAT_FIELDS = ("mass", "center", "vmean", "vdisp", "rmax")
# float32 sums of a few hundred particles taken in another order.
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)

SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, {tests!r})
    from conftest import make_clustered_points
    from repro.core.distributed import slab_partition
    from repro.halos.merge import (halo_catalog_sharded,
                                   halo_pipeline_sharded, halo_pipeline_traced)
    from repro.obs import SpanTracer

    rng = np.random.default_rng(7)
    pts, order = slab_partition(make_clustered_points(rng, {n}), 4)
    vel = rng.standard_normal(({n}, 3)).astype(np.float32)[order]
    out = {{"pts": pts, "vel": vel}}
    jp, jv = jnp.asarray(pts), jnp.asarray(vel)
    mesh = {{s: Mesh(np.array(jax.devices()[:s]), ("data",)) for s in (1, 2, 4)}}
    kw = dict(capacity={cap}, min_count={min_count}, halo_cap=512)

    def keep(key, res):
        for f in res._fields:
            v = getattr(res, f)
            if f == "catalog":
                keep(key + "/catalog", v)
            elif f == "so":
                if v is not None:
                    keep(key + "/so", v)
            else:
                out[key + "/" + f] = np.asarray(v)

    for s in (1, 2, 4):
        keep(f"pipe/{{s}}/int32", halo_pipeline_sharded(
            jp, jv, {eps}, 2, mesh=mesh[s], **kw))
        with jax.enable_x64(True):
            keep(f"pipe/{{s}}/int64", halo_pipeline_sharded(
                jp, jv, {eps}, 2, mesh=mesh[s], index_dtype=jnp.int64, **kw))
    keep("so", halo_pipeline_sharded(jp, jv, {eps}, 2, mesh=mesh[4],
                                     so_delta=200.0, so_r_max=0.1, **kw))
    with jax.enable_x64(True):
        labels = jnp.asarray(out["pipe/2/int64/labels"])
        keep("cat/2/int64", halo_catalog_sharded(
            jp, jv, labels, mesh=mesh[2], capacity={cap}, min_count={min_count}))
    tracer = SpanTracer()
    halo_pipeline_traced(jp, jv, {eps}, 2, mesh=mesh[2], tracer=tracer,
                         so_delta=200.0, so_r_max=0.1, **kw)
    out["trace"] = np.array(json.dumps(
        [(e["name"], e["ph"], e["args"]) for e in tracer.events]))
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_merge") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(TESTS), "src")
    env.pop("XLA_FLAGS", None)
    code = SCRIPT.format(tests=TESTS, n=N, eps=EPS, cap=CAP,
                         min_count=MIN_COUNT, path=path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _assert_catalog(got, want, key=""):
    """``want``: a reference catalog, or a dict of its fields under
    ``key``. Integers and dtypes exact, float sums within FLOAT_TOL. The
    count of halos is int32 in the port; the reference's ``jnp.sum``
    gives int64 under x64, so only its value is compared."""
    for f in got._fields:
        w = want[f"{key}/{f}"] if isinstance(want, dict) \
            else np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert f == "num_halos" or g.dtype == w.dtype, (f, g.dtype, w.dtype)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **FLOAT_TOL)


def _assert_pipeline(got, ref, key):
    for f in ("labels", "core_mask", "rounds", "halo_overflow"):
        g, w = getattr(got, f).numpy(), ref[f"{key}/{f}"]
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    _assert_catalog(got.catalog, ref, f"{key}/catalog")


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_halo_pipeline_sharded_matches_reference(ref, shards, dtype):
    got = halo_pipeline_sharded(
        ref["pts"], ref["vel"], EPS, 2, mesh=ShardMesh(shards, "cpu"),
        capacity=CAP, min_count=MIN_COUNT, index_dtype=getattr(torch, dtype))
    assert not bool(got.halo_overflow) and got.so is None
    assert int(got.catalog.num_halos) > 3
    _assert_pipeline(got, ref, f"pipe/{shards}/{dtype}")
    # the labels are the single-device FDBSCAN's
    assert torch.equal(got.labels.to(torch.int32),
                       fdbscan(ref["pts"], EPS, 2, device="cpu").labels)


def test_halo_pipeline_so_matches_reference(ref):
    """SO masses from the psum'd per-shard counts, exactly the
    reference's."""
    got = halo_pipeline_sharded(ref["pts"], ref["vel"], EPS, 2,
                                mesh=ShardMesh(4, "cpu"), capacity=CAP,
                                min_count=MIN_COUNT, **SO)
    _assert_pipeline(got, ref, "so")
    assert bool(got.so.bracketed.any())
    for f in got.so._fields:
        g, w = getattr(got.so, f).numpy(), ref[f"so/so/{f}"]
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_halo_catalog_sharded_matches_reference(ref):
    """The sharded catalog of the reference's own int64 labels."""
    labels = ref["pipe/2/int64/labels"]
    got = halo_catalog_sharded(ref["pts"], ref["vel"], labels,
                               mesh=ShardMesh(2, "cpu"), capacity=CAP,
                               min_count=MIN_COUNT)
    _assert_catalog(got, ref, "cat/2/int64")
    assert got.root.dtype == torch.int64


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_traced_pipeline_equals_fused(ref, shards, tmp_path):
    """``halo_pipeline_traced`` gives ``halo_pipeline_sharded``'s result bit
    for bit (SO included), under the reference's spans and counters."""
    mesh = ShardMesh(shards, "cpu")
    kw = dict(mesh=mesh, capacity=CAP, min_count=MIN_COUNT, **SO)
    fused = halo_pipeline_sharded(ref["pts"], ref["vel"], EPS, 2, **kw)
    tracer = SpanTracer()
    staged = halo_pipeline_traced(ref["pts"], ref["vel"], EPS, 2,
                                  tracer=tracer, **kw)
    for f in ("labels", "core_mask", "rounds", "halo_overflow"):
        assert torch.equal(getattr(staged, f), getattr(fused, f)), f
    for part in ("catalog", "so"):
        for f in getattr(fused, part)._fields:
            a = getattr(getattr(fused, part), f)
            b = getattr(getattr(staged, part), f)
            assert torch.equal(a, b), (part, f)
    if shards == 2:
        want = json.loads(str(ref["trace"]))
        got = [[e["name"], e["ph"], e["args"]] for e in tracer.events]
        assert got == want


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("shards", [2, 4])
def test_partial_and_merged_catalogs_match_reference(shards, dtype):
    """The pure functions without a mesh, shard by shard, against the
    reference's on the same slabs (int64: labels past 2^32, under x64):
    partial roots and merged integers exact, per-shard slot maps exact,
    and the merge equal to the single-device catalog."""
    rng = np.random.default_rng(shards)
    pts, order = slab_partition(make_clustered_points(rng, 480), shards)
    vel = rng.standard_normal((480, 3)).astype(np.float32)[order]
    labels = fdbscan(pts, 0.07, 5, device="cpu").labels.numpy()
    if dtype == "int64":
        labels = np.where(labels >= 0, labels.astype(np.int64) + 2**32, -1)
    chunks = np.array_split(np.arange(len(pts)), shards)
    cap = 32
    with jax.enable_x64(dtype == "int64"):
        jparts = [jax_merge.partial_catalog(
            jnp.asarray(pts[c]), jnp.asarray(vel[c]), jnp.asarray(labels[c]),
            capacity=cap) for c in chunks]
        want = jax_merge.merge_partial_catalogs(
            jnp.concatenate([p.root for p in jparts]),
            jnp.concatenate([p.sums for p in jparts]), capacity=cap,
            min_count=5)
        rmax2 = jnp.full((cap,), -SEG_NEG_BIG)
        for c in chunks:
            rmax2 = jnp.maximum(rmax2, jax_merge.local_rmax2(
                jnp.asarray(pts[c]), jnp.asarray(labels[c]), want))
        want = jax_merge.finalize_rmax(want, rmax2)
        want_slots = [np.asarray(jax_merge.particle_slots(
            jnp.asarray(labels[c]), want)) for c in chunks]
    t = [torch.from_numpy(a) for a in (pts, vel, labels)]
    parts = [partial_catalog(t[0][c], t[1][c], t[2][c], capacity=cap)
             for c in chunks]
    for p, jpart in zip(parts, jparts):
        np.testing.assert_array_equal(p.root.numpy(), np.asarray(jpart.root))
        np.testing.assert_allclose(p.sums.numpy(), np.asarray(jpart.sums),
                                   **FLOAT_TOL)
    got = merge_partial_catalogs(torch.cat([p.root for p in parts]),
                                 torch.cat([p.sums for p in parts]),
                                 capacity=cap, min_count=5)
    rmax2 = torch.stack([local_rmax2(t[0][c], t[2][c], got)
                         for c in chunks]).amax(0)
    got = finalize_rmax(got, rmax2)
    _assert_catalog(got, want)
    single = halo_catalog(pts, vel, labels, capacity=cap, min_count=5,
                          device="cpu")
    for c, ws in zip(chunks, want_slots):
        slots = particle_slots(t[2][c], got).numpy()
        np.testing.assert_array_equal(slots, ws)
        np.testing.assert_array_equal(slots, single.particle_halo.numpy()[c])
    for f in ("num_halos", "root", "count"):
        assert torch.equal(getattr(got, f), getattr(single, f)), f


def test_halo_catalog_sharded_equals_single_device():
    """On the mesh: integers equal the single-device catalog's, floats
    within FLOAT_TOL, with int64 labels past 2^32."""
    rng = np.random.default_rng(11)
    pts, _ = slab_partition(make_clustered_points(rng, 600), 3)
    vel = rng.standard_normal((600, 3)).astype(np.float32)
    labels = fdbscan(pts, 0.05, 2, device="cpu").labels.long()
    labels = torch.where(labels >= 0, labels + 2**32, -1)
    got = halo_catalog_sharded(pts, vel, labels, mesh=ShardMesh(3, "cpu"),
                               capacity=64, min_count=3)
    want = halo_catalog(pts, vel, labels, capacity=64, min_count=3,
                        device="cpu")
    assert int(want.num_halos) > 3
    for f in INT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   **FLOAT_TOL)


@pytest.mark.parametrize("labels_as", ["numpy", "tensor"])
def test_catalog_keeps_int64_labels(labels_as):
    """ROADMAP C10: eight particles with labels [2^32+1]*3 + [1]*3 +
    [-1]*2 and capacity 4 give the reference's two halos (under x64), not
    one halo of six wrapped labels."""
    labels = np.array([2**32 + 1] * 3 + [1] * 3 + [-1] * 2, np.int64)
    pts = np.random.default_rng(0).random((8, 3)).astype(np.float32)
    with jax.enable_x64(True):
        want = jax_catalog.halo_catalog(jnp.asarray(pts), jnp.asarray(pts),
                                        jnp.asarray(labels), capacity=4,
                                        min_count=2)
    lab = torch.from_numpy(labels) if labels_as == "tensor" else labels
    got = halo_catalog(pts, pts, lab, capacity=4, min_count=2, device="cpu")
    np.testing.assert_array_equal(got.root.numpy(), [1, 2**32 + 1, -1, -1])
    np.testing.assert_array_equal(got.count.numpy(), [3, 3, 0, 0])
    _assert_catalog(got, want)
