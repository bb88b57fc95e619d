"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's on abstract production meshes, ``op_cost`` against the
reference's HLO walker, and the dry run's CLI on one cell."""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import abstract_mesh  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.spec import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.op_cost import op_cost  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.spec import _spec_leaves, abstract_params, init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdr():
    """The reference's dry-run module, imported after JAX has its one CPU
    device (its import sets a 512-device ``XLA_FLAGS``, which is put
    back so that no later process sees it)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _c16_gap(cfg, shape) -> float:
    """ROADMAP C16, pinned: the reference counts every leaf of a ``*_moe``
    sublayer as a routed expert, so the sublayer's attention or Mamba and
    its norms are scaled by ``1 - top_k / n_experts`` too. The port counts
    only the ``['moe']`` experts; its model FLOPs exceed the reference's
    by those parameters' inactive share."""
    missed = sum(int(np.prod(s.shape)) for keys, s in _spec_leaves(lm.model_spec(cfg))
                 if any(k.endswith("_moe") for k in keys) and "moe" not in keys)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    assert missed > 0
    return mult * tokens * missed * (1 - cfg.top_k / cfg.n_experts)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_reference(jdr, arch, kind):
    """At ``hbm_bytes=16e9``, in every cell ``shapes_for`` assigns:
    ``train_plan``, ``memory_model`` (every key but ``fits_*``; the
    port's ``fits_hbm`` equals the reference's ``fits_16GB``),
    ``sharded_param_bytes`` and ``input_specs``' shapes and dtypes equal
    the reference's exactly; so does ``model_flops`` for the dense
    models, and for the MoE models it differs by the C16 gap alone."""
    sizes, names = MESHES[kind]
    mesh, jmesh = make_production_mesh(multi_pod=kind == "multi"), abstract_mesh(sizes, names)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert [s.name for s in shapes_for(cfg)] == [s.name for s in jax_shapes_for(jcfg)]
    assert dr.sharded_param_bytes(cfg, mesh) == jdr.sharded_param_bytes(jcfg, jmesh)
    for shape in shapes_for(cfg):
        got = dr.memory_model(cfg, shape, mesh, hbm_bytes=16e9)
        want = jdr.memory_model(jcfg, shape, jmesh)
        assert got.pop("fits_hbm") == want.pop("fits_16GB")
        assert got.pop("hbm_bytes") == 16e9
        assert got == want, (arch, shape.name)
        if shape.kind == "train":
            assert dr.train_plan(cfg, shape, mesh, hbm_bytes=16e9) == \
                jdr.train_plan(jcfg, shape, jmesh)
            assert dr.accum_steps_for(cfg, shape, mesh, hbm_bytes=16e9) == \
                jdr.accum_steps_for(jcfg, shape, jmesh)
        if cfg.is_moe:
            assert dr.model_flops(cfg, shape) == pytest.approx(
                jdr.model_flops(jcfg, shape) + _c16_gap(cfg, shape), rel=1e-12)
        else:
            assert dr.model_flops(cfg, shape) == jdr.model_flops(jcfg, shape)
        ins, jins = dr.input_specs(cfg, shape), jdr.input_specs(jcfg, shape)
        assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in ins.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jins.items()}
        assert all(v.device.type == "meta" for v in ins.values())


def test_budgets_scale_with_hbm():
    """The budgets are fractions of ``hbm_bytes`` (12/16, 15/16, 1/16 and
    4/16 of it); at the default, the H100's 80 GB, jamba-398B's state on
    one pod keeps f32 gradients, which 16 GB forced to bf16."""
    mesh = make_production_mesh()
    cfg, shape = get_config("jamba-1.5-large-398b"), SHAPES["train_4k"]
    for hbm in (16e9, 80e9, 85.0e9):
        plan = dr.train_plan(cfg, shape, mesh, hbm_bytes=hbm)
        pb = plan["params_b"]
        gdt = "bfloat16" if pb * 5 > hbm * 12 / 16 else "float32"
        assert plan["grad_dtype"] == gdt
        state = pb * 3 + pb * (1 if gdt == "bfloat16" else 2)
        assert plan["carry_budget"] == float(np.clip(hbm * 15 / 16 - state,
                                                     hbm / 16, hbm * 4 / 16))
        mm = dr.memory_model(cfg, shape, mesh, hbm_bytes=hbm)
        assert mm["hbm_bytes"] == hbm and mm["fits_hbm"] == (mm["total"] < hbm)
    assert dr.train_plan(cfg, shape, mesh, hbm_bytes=16e9)["grad_dtype"] == "bfloat16"
    default = dr.train_plan(cfg, shape, mesh)
    assert default["grad_dtype"] == "float32" and dr.HBM_BYTES == 80e9
    assert default["carry_budget"] == 20e9
    assert dr.memory_model(cfg, shape, mesh)["hbm_bytes"] == 80e9


def test_abstract_params_and_opt_state_allocate_nothing():
    """``meta`` leaves of the specs' shapes at full size (jamba-398B), and
    ``abstract_opt_state`` with ``init_opt_state``'s structure."""
    cfg = get_config("jamba-1.5-large-398b")
    spec = lm.model_spec(cfg)
    params = abstract_params(spec, torch.bfloat16)
    specs = _spec_leaves(spec)
    assert len(specs) == len(leaves(params))
    for x, (_, s) in zip(leaves(params), specs):
        assert x.device.type == "meta" and x.dtype == torch.bfloat16
        assert tuple(x.shape) == s.shape
    oc = adamw.OptConfig(compress_grads=True)
    opt = adamw.abstract_opt_state(oc, params)
    assert opt.step.shape == () and opt.step.dtype == torch.int32
    assert all(x.dtype == torch.bfloat16 and x.device.type == "meta" for x in leaves(opt.m))
    assert all(x.dtype == torch.float32 for x in leaves(opt.error))
    small = get_config("xlstm-350m").smoke()
    real = adamw.init_opt_state(oc, init_params(lm.model_spec(small), 0, device="cpu"))
    meta = adamw.abstract_opt_state(oc, abstract_params(lm.model_spec(small)))
    assert [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(real)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(meta)]


def _reference_hlo(fn, args, tmp_path) -> str:
    """The reference's own HLO of ``fn`` before XLA's optimizations, the
    point of its pipeline the reference's dry run reads (the SPMD
    partitioner, after which it dumps, does not run on one device)."""
    dump = tmp_path / "hlo"
    jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_dump_to": str(dump), "xla_dump_hlo_pass_re": "spmd-partitioning"})
    (path,) = glob.glob(str(dump / "*jit_*before_optimizations.txt"))
    return open(path).read()


@pytest.mark.parametrize("arch,rel", [("xlstm-350m", 0.01), ("codeqwen1.5-7b", 0.0)])
def test_op_cost_flops_match_hlo_walker(arch, rel, tmp_path):
    """One train step (forward, backward with the groups' recompute,
    AdamW) of the smoke config at batch 2 x 16, f32, on the same weights:
    ``op_cost``'s FLOPs against ``hlo_cost.analyze_hlo`` on the
    reference's HLO of its own step, within ``rel``. Dense attention
    (codeqwen1.5-7b) is exact (2.5166e7 FLOPs each). xlstm's count lies
    200,704 FLOPs (0.70%) under the walker's 2.8869e7, all in mLSTM's
    chunk scan, whose ``lax.scan`` body computes every carry cotangent
    each iteration: through the first chunk's zero initial state (the
    ``bhik,bhkl`` product's ``C0`` side, 65,536, and the ``bhik,bhk``
    product's ``n0`` side, 4,096) and from the last chunk's unused final
    state (both sides of ``bhjk,bhjl->bhkl``, 65,536 each). Torch's
    autograd forms no gradient there: nothing flows into a tensor that
    needs none or out of one that no loss reads."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jp = jax_init_params(jlm.model_spec(jcfg), jax.random.PRNGKey(0), jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.tensor(tok), "labels": torch.tensor(tok),
          "loss_mask": torch.tensor(mask)}
    jo, to = jadamw.OptConfig(), adamw.OptConfig()
    hlo = _reference_hlo(
        lambda st, b: jsteps.train_step(st, b, cfg=jcfg, opt_cfg=jo),
        (jsteps.TrainState(jp, jadamw.init_opt_state(jo, jp)), jb), tmp_path)
    want = analyze_hlo(hlo)["flops"]
    got = op_cost(steps.train_step, steps.TrainState(p, adamw.init_opt_state(to, p)), tb,
                  cfg=cfg, opt_cfg=to)
    assert want > 0 and abs(got["flops"] - want) <= rel * want, (got["flops"], want)
    if arch == "xlstm-350m":
        assert got["flops"] == want - 200704


def test_op_cost_on_meta_equals_the_cpu_step():
    """The dry run's ``build_cell`` step at batch 2 x 16 of the smoke xlstm:
    the same FLOPs, traffic and op count on ``meta`` and on real CPU
    tensors (the contract phase 18 checks on the card); a real count of
    one small op."""
    cfg = get_config("xlstm-350m").smoke()
    cell = dr.ShapeConfig("toy", "train", 16, 2)
    mesh = make_production_mesh()
    fn, args = dr.build_cell(cfg, cell, mesh)
    on_meta = op_cost(fn, *args, top_k=3)
    real = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype), args)
    on_cpu = op_cost(fn, *real)
    assert on_meta["flops"] == on_cpu["flops"] > 0
    assert on_meta["traffic"] == on_cpu["traffic"] > 0
    assert on_meta["ops"] == on_cpu["ops"]
    assert len(on_meta["top_flops"]) == 3 and on_meta["top_flops"][0]["flops"] > 0
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    c = op_cost(lambda: (a @ b).t().contiguous())
    assert c["flops"] == 2 * 4 * 8 * 3
    assert c["traffic"] == 2 * (4 * 3 * 4) * 2      # mm and the copy; t() is a view


def test_cli_writes_one_cell(tmp_path, capsys):
    """``main`` on one cell writes its JSON and prints the summary line;
    ``diagnose`` prints the same cell's memory model and top ops."""
    from repro_torch.launch import diagnose
    argv = ["--arch", "xlstm-350m", "--shape", "long_500k", "--out", str(tmp_path)]
    assert dr.main(argv) == 0
    res = json.loads((tmp_path / "xlstm-350m__long_500k__single.json").read_text())
    assert res["n_chips"] == 256 and res["kind"] == "decode"
    assert res["memory"]["fits_hbm"] and res["memory"]["hbm_bytes"] == 80e9
    assert res["roofline"]["t_collective_s"] is None
    assert res["roofline"]["dominant"] in ("compute", "memory")
    assert res["cost"]["flops"] > 0 and res["pinned"]["decode_score"] == \
        ["data", None, None, "model"]
    out = json.loads(capsys.readouterr().out)
    assert out["cell"] == "xlstm-350m x long_500k x single" and out["fits"]
    assert diagnose.main(["--arch", "xlstm-350m", "--shape", "long_500k", "--top", "3"]) == 0
    text = capsys.readouterr().out
    assert "memory model (GB)" in text and "top ops by FLOPs" in text
