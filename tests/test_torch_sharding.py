"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's on abstract production meshes, and the placements on a
one-rank gloo host mesh. The reference's ``PartitionSpec`` is compared as
a tuple of its entries."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from conftest import abstract_mesh  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.spec import TensorSpec as JaxTensorSpec  # noqa: E402
from repro.models.spec import is_spec as jax_is_spec  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.spec import TensorSpec, _spec_leaves, init_params  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.tree import keystr, leaves_with_path  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    """(the port's abstract mesh, the reference's AbstractMesh)."""
    sizes, names = MESHES[kind]
    return make_production_mesh(multi_pod=kind == "multi"), abstract_mesh(sizes, names)


def _t(p) -> tuple:
    return tuple(p)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.axis_names == ("pod", "data", "model")


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, kind):
    """Every leaf of ``model_spec``: ``pspec_for`` equals the reference's,
    leaf for leaf in the same order, and no mesh axis repeats in one."""
    mesh, jmesh = _meshes(kind)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jlm.model_spec(jax_get_config(arch)), is_leaf=jax_is_spec)[0]
    ours = _spec_leaves(lm.model_spec(get_config(arch)))
    assert len(ours) == len(jleaves)
    for (keys, spec), (jpath, jspec) in zip(ours, jleaves):
        path = keystr(tuple(f"[{k!r}]" for k in keys))
        assert path == jax.tree_util.keystr(jpath)
        got = shd.pspec_for(spec, mesh)
        assert _t(got) == _t(jshd.pspec_for(jspec, jmesh)), path
        used = [a for e in got if e is not None for a in ((e,) if isinstance(e, str) else e)]
        assert len(used) == len(set(used)), path


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rule_corner_cases_match_reference(kind):
    """The divisibility guard, the prefix fit of ("pod", "data") and the
    one-use rule on hand-made specs."""
    mesh, jmesh = _meshes(kind)
    cases = [((4096, 64, 128), ("embed", "heads", "qkv")),
             ((4096, 1, 128), ("embed", "kv", "qkv")),
             ((4096, 8, 128), ("embed", "kv", "qkv")),
             ((2 * 7, 64), ("embed", "mlp")),
             ((64, 128), ("heads", "mlp")),
             ((64, 2048, 1408), ("experts", "embed", "mlp")),
             ((3, 5), (None, "layers"))]
    for shape, axes in cases:
        assert _t(shd.pspec_for(TensorSpec(shape, axes), mesh)) == \
            _t(jshd.pspec_for(JaxTensorSpec(shape, axes), jmesh)), (shape, axes)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_data_score_and_activation_pspecs_match_reference(kind):
    mesh, jmesh = _meshes(kind)
    for batch in (1, 2, 16, 32, 128, 256, 48):
        for ndim in (1, 2, 3):
            assert _t(shd.data_pspec(mesh, batch, ndim)) == \
                _t(jshd.data_pspec(jmesh, batch, ndim)), (batch, ndim)
    for arch in ARCH_IDS:
        h = get_config(arch).n_heads
        assert _t(shd.default_score_pspec(mesh, h)) == \
            _t(jshd.default_score_pspec(jmesh, h)), arch
    assert _t(shd.default_score_pspec(mesh)) == _t(jshd.default_score_pspec(jmesh))
    assert _t(shd.decode_score_pspec(mesh)) == _t(jshd.decode_score_pspec(jmesh))
    assert _t(shd.default_attn_input_pspec(mesh)) == \
        _t(jshd.default_attn_input_pspec(jmesh))
    for ok in (True, False):
        assert _t(shd.default_activation_pspec(mesh, ok)) == \
            _t(jshd.default_activation_pspec(jmesh, ok))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch, kind):
    """Every leaf of the decode_32k cache: ``cache_pspecs`` (batch dim 0
    under ``layer0``, else 1) equals the reference's ``cache_shardings``,
    and ``cache_pspec`` at each batch dim equals the reference's."""
    mesh, jmesh = _meshes(kind)
    shape = SHAPES["decode_32k"]
    cache = lm.init_cache(get_config(arch), shape.global_batch, shape.seq_len,
                          device="meta")
    jcache = jax.eval_shape(lambda: jlm.init_cache(
        jax_get_config(arch), shape.global_batch, shape.seq_len))
    want = jax.tree_util.tree_flatten_with_path(jshd.cache_shardings(jcache, jmesh))[0]
    got = leaves_with_path(shd.cache_pspecs(cache, mesh))
    assert [keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, spec), (_, jsharding) in zip(got, want):
        assert _t(spec) == _t(jsharding.spec), keystr(path)
    for path, x in leaves_with_path(cache):
        for bd in (0, 1):
            assert _t(shd.cache_pspec(mesh, tuple(x.shape), bd)) == \
                _t(jshd.cache_pspec(jmesh, tuple(x.shape), bd)), (keystr(path), bd)


def test_pins_record_what_is_set():
    mesh, _ = _meshes("multi")
    before = shd.pinned()
    try:
        shd.set_score_pspec(shd.default_score_pspec(mesh, 40))
        shd.set_decode_score_pspec(None)
        assert shd.pinned()["score"] == (("pod", "data"), None, "model", None)
        assert shd.pinned()["decode_score"] is None
    finally:
        shd.set_score_pspec(before["score"])
        shd.set_decode_score_pspec(before["decode_score"])


def _dict_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order; a tuple of placements
    is one leaf."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]


@pytest.fixture
def host_mesh():
    """A one-rank gloo host mesh; the process group ends at teardown."""
    import torch.distributed as dist
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_host_mesh_and_param_placements_round_trip(host_mesh):
    """The host mesh is (1, 1) over ("data", "model") on gloo; every leaf of
    a smoke xlstm is placed by ``param_placements`` (one placement a mesh
    dim, ``Shard(d)`` where its spec names the dim) and comes back equal
    through ``to_local()``."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    assert tuple(host_mesh.shape) == (1, 1)
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert dist.get_backend() == "gloo"
    cfg = get_config("xlstm-350m").smoke()
    spec = lm.model_spec(cfg)
    params = init_params(spec, 0, torch.float32, "cpu")
    places = shd.param_placements(spec, host_mesh)
    pspecs = shd.param_pspecs(spec, host_mesh)
    for keys, s in _spec_leaves(spec):
        pl, ps, x = places, pspecs, params
        for k in keys:
            pl, ps, x = pl[k], ps[k], x[k]
        assert len(pl) == 2
        for ax, p in zip(("data", "model"), pl):
            dims = [d for d, e in enumerate(ps)
                    if e == ax or (isinstance(e, tuple) and ax in e)]
            assert p == (Shard(dims[0]) if dims else Replicate()), (keys, ps, pl)
        back = distribute_tensor(x, host_mesh, list(pl)).to_local()
        assert torch.equal(back, x), keys
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    placed = _dict_leaves(shd.cache_shardings(cache, host_mesh))
    assert len(placed) == len(leaves_with_path(cache))
    for (path, x), pl in zip(leaves_with_path(cache), placed):
        assert len(pl) == 2, keystr(path)
        assert torch.equal(distribute_tensor(x, host_mesh, list(pl)).to_local(), x)
    # ("pod", "data") over one dim: Shard(d) on both mesh dims.
    from repro_torch.launch.mesh import AbstractMesh
    three = AbstractMesh(("pod", "data", "model"), (1, 1, 1))
    ps = shd.pspec_for(TensorSpec((8, 4), ("embed", "mlp")), three)
    assert _t(ps) == (("pod", "data"), "model")
    assert shd.placements_for(ps, three) == (Shard(0), Shard(0), Shard(1))
