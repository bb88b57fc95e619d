"""Dry run: the training and serving plan of every (architecture x input
shape x mesh) cell on the production meshes, and its roofline; port of
``repro/launch/dryrun.py``.

For every cell this:
  1. builds the step's inputs as ``meta`` tensors (no allocation at any
     size): parameters, optimizer state, batch or decode cache;
  2. plans it at the reference's formulas: the sharded parameter bytes,
     the training plan (gradient dtype, accumulation), the analytic memory
     per device against ``hbm_bytes`` and the model FLOPs;
  3. counts the step's FLOPs and traffic with ``op_cost`` (every op it
     dispatches on ``meta``), divided by the mesh's chip count;
  4. derives the compute and memory roofline terms against the H100 SXM5
     datasheet's rates. The collective term is not modelled: one process
     has no partitioner to read it from.

CLI:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs N]

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

The memory budgets are the reference's fractions of its 16 GB HBM, so
``hbm_bytes=16e9`` gives the reference's numbers; the default is the
H100's 80 GB.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import op_cost
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.models.spec import _spec_leaves, abstract_params, count_params
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.tree import leaves, tree_map

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# --- NVIDIA H100 SXM5 datasheet figures (per card) ---------------------------
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = 80e9             # NVIDIA H100 80GB HBM3

# The reference's budgets as fractions of its 16 GB: f32 gradients while
# params + moments + grads stay under 12 GB; the carry budget is what is
# left of 15 GB, clipped to [1 GB, 4 GB].
GRAD_F32_FRAC = 12 / 16
CARRY_LEFT_FRAC = 15 / 16
CARRY_MIN_FRAC = 1 / 16
CARRY_MAX_FRAC = 4 / 16


# ---------------------------------------------------------------------------
# Abstract inputs per cell
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs for one cell (tokens/labels or decode state)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32),
                 "loss_mask": _meta((b, s), torch.bool)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode: one token against an S-token cache
        batch = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.frontend_dim and not cfg.encoder_layers:
        batch["vision"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16)
    if cfg.encoder_layers:
        batch["frames"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16)
    return batch


def _spec_list(cfg: ModelConfig):
    return [s for _, s in _spec_leaves(lm.model_spec(cfg))]


def sharded_param_bytes(cfg: ModelConfig, mesh) -> float:
    """Exact per-device parameter bytes (bf16) under the sharding rules."""
    return sum(int(np.prod(l.shape)) * 2 / _shard_factor(l, mesh)
               for l in _spec_list(cfg))


def train_plan(cfg: ModelConfig, shape: ShapeConfig, mesh, sp: bool = False,
               hbm_bytes: float = HBM_BYTES) -> dict:
    """Shared training-memory plan: gradient dtype and accumulation factor,
    derived from the exact sharded state footprint (used by build_cell AND
    memory_model so the dry run counts what it models).

    * grads accumulate in bf16 when the f32 accumulator would push
      params+moments+grads past ``GRAD_F32_FRAC`` of HBM;
    * the scan-carry budget is what's left of HBM after state+slack.
    """
    params_b = sharded_param_bytes(cfg, mesh)
    state_f32g = params_b * (1 + 2 + 2)          # p + m/v bf16 + f32 grads
    grad_dtype = "bfloat16" if state_f32g > GRAD_F32_FRAC * hbm_bytes else "float32"
    grad_b = params_b * (1 if grad_dtype == "bfloat16" else 2)
    state_b = params_b * 3 + grad_b
    carry_budget = float(np.clip(CARRY_LEFT_FRAC * hbm_bytes - state_b,
                                 CARRY_MIN_FRAC * hbm_bytes, CARRY_MAX_FRAC * hbm_bytes))

    sizes = shd._mesh_axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    rows_total = max(shape.global_batch // dp, 1)
    carry_per_row = cfg.n_groups * shape.seq_len * cfg.d_model * 2
    if cfg.encoder_layers:  # enc-dec: encoder scan carries count too
        carry_per_row += cfg.encoder_layers * cfg.frontend_tokens * cfg.d_model * 2
    if any(k.startswith(("mlstm", "slstm")) for k in cfg.block_pattern):
        # xLSTM gate preactivations (4 per block) dominate the carry
        carry_per_row += 4 * shape.seq_len * cfg.n_heads * cfg.resolved_head_dim * 4
    if sp and shape.seq_len % sizes.get("model", 1) == 0:
        carry_per_row /= sizes.get("model", 1)  # seq-sharded saved carries
    rows = max(1, min(rows_total, int(carry_budget // max(carry_per_row, 1))))
    accum = 1
    while rows_total // accum > rows and rows_total % (accum * 2) == 0:
        accum *= 2
    return {"accum": accum, "rows": rows_total // accum,
            "grad_dtype": grad_dtype, "params_b": params_b,
            "carry_budget": carry_budget}


SP_MODE = False  # set by run_cell/diagnose; threads --sp into the plan


def accum_steps_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    hbm_bytes: float = HBM_BYTES) -> int:
    return train_plan(cfg, shape, mesh, sp=SP_MODE, hbm_bytes=hbm_bytes)["accum"]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, hbm_bytes: float = HBM_BYTES):
    """Returns ``(fn, args)``: the cell's step and its ``meta`` inputs.
    train: ``train_step``, or ``train_step_accum`` over the plan's
    ``(accum, B/accum, ...)`` micro-batches; prefill: ``prefill_step``;
    decode: ``serve_step`` on a ``meta`` cache."""
    params = abstract_params(lm.model_spec(cfg), torch.bfloat16)
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        plan = train_plan(cfg, shape, mesh, sp=SP_MODE, hbm_bytes=hbm_bytes)
        accum = plan["accum"]
        opt_cfg = adamw.OptConfig(accum_steps=accum, grad_dtype=plan["grad_dtype"])
        state = steps.TrainState(params, adamw.abstract_opt_state(opt_cfg, params))
        if accum > 1:  # micro-batch leading axis: (accum, B/accum, ...)
            batch = tree_map(lambda x: _meta((accum, x.shape[0] // accum) + x.shape[1:],
                                             x.dtype), batch)

            def fn(st, bt):
                return steps.train_step_accum(st, bt, cfg=cfg, opt_cfg=opt_cfg)
        else:
            def fn(st, bt):
                return steps.train_step(st, bt, cfg=cfg, opt_cfg=opt_cfg)
        return fn, (state, batch)

    if shape.kind == "prefill":
        def fn(p, bt):
            return steps.prefill_step(p, bt, cfg=cfg, cache_len=shape.seq_len)
        return fn, (params, batch)

    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")

    def fn(p, c, t, pp):
        return steps.serve_step(p, c, t, pp, cfg=cfg)
    return fn, (params, cache, batch["tokens"], _meta((), torch.int32))


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def _spec_factor(pspec, sizes: dict) -> int:
    f = 1
    for entry in pspec:
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            f *= sizes[ax]
    return f


def _shard_factor(spec, mesh) -> int:
    return _spec_factor(shd.pspec_for(spec, mesh), shd._mesh_axis_sizes(mesh))


def memory_model(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 hbm_bytes: float = HBM_BYTES) -> dict:
    """Analytic per-device HBM model at the step's dtypes (bf16 weights,
    moments and activations, f32 where the program deliberately uses f32),
    and whether its total fits ``hbm_bytes``."""
    sizes = shd._mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    params_b = sum(int(np.prod(l.shape)) * 2 / _shard_factor(l, mesh)
                   for l in _spec_list(cfg))

    s, b = shape.seq_len, shape.global_batch
    d, hq = cfg.d_model, cfg.n_heads
    # score sharding mirror of default_score_pspec: heads over model when
    # divisible, else query-seq over model
    if hq % model == 0:
        h_loc, sq_div = hq / model, 1
    else:
        h_loc, sq_div = hq, model
    out: dict = {"params": params_b}
    kinds = {k.removesuffix("_moe") for k in cfg.block_pattern}
    attends = bool(kinds & {"attn", "attn_local", "cross"})

    if shape.kind == "train":
        plan = train_plan(cfg, shape, mesh, sp=SP_MODE, hbm_bytes=hbm_bytes)
        accum = plan["accum"]
        rows = max(b // dp // accum, 1)
        out["opt_moments"] = 2 * params_b               # bf16 m+v
        out["grads"] = params_b * (1 if plan["grad_dtype"] == "bfloat16" else 2)
        carry = cfg.n_groups * rows * s * d * 2
        if cfg.encoder_layers:
            carry += cfg.encoder_layers * rows * cfg.frontend_tokens * d * 2
        out["scan_carries"] = carry
        transients = []
        if attends:
            if s >= A.CHUNKED_THRESHOLD:  # blockwise attention tiles
                transients.append(
                    2.5 * rows * h_loc * (A.Q_CHUNK / sq_div) * A.KV_CHUNK * 4)
            else:
                transients.append(2.5 * rows * h_loc * (s / sq_div) * s * 4)
        if cfg.is_moe:
            tg = min(cfg.moe_group_size, rows * s)
            g_loc = rows * s // tg
            cap = max(1, min(int(cfg.capacity_factor * tg * cfg.top_k
                                 / cfg.n_experts), tg))
            e_loc = max(cfg.n_experts // model, 1)
            disp = g_loc * tg * e_loc * cap * 2
            buf = g_loc * e_loc * cap * d * 2
            transients.append(2.5 * (2 * disp + 2 * buf))
        if "mamba" in kinds:
            di_loc = cfg.ssm_expand * d / model
            transients.append(
                3 * rows * cfg.ssm_chunk * di_loc * cfg.ssm_state * 4)
        if kinds & {"mlstm", "slstm"}:
            hd = cfg.resolved_head_dim
            transients.append(3 * rows * hq * max(cfg.ssm_chunk ** 2,
                                                  hd * hd) * 4)
            transients.append(4 * rows * s * hq * hd * 4)          # gate preacts
        pv = cfg.padded_vocab
        v_loc = pv / model if pv % model == 0 else pv
        transients.append(2 * rows * lm.LOSS_CHUNK * v_loc * 4)    # loss chunk
        out["transient_peak"] = max(transients)
    else:
        cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        cache_b = 0.0
        for leaf in leaves(cache):
            f = _spec_factor(shd.cache_pspec(mesh, tuple(leaf.shape)), sizes)
            cache_b += int(np.prod(leaf.shape)) * leaf.element_size() / f
        out["kv_cache"] = cache_b
        rows = max(b // dp, 1)
        if shape.kind == "prefill":
            out["activations"] = 4 * rows * s * d * 2
            if attends:
                if s >= A.CHUNKED_THRESHOLD:
                    out["transient_peak"] = \
                        2 * rows * h_loc * (A.Q_CHUNK / sq_div) * A.KV_CHUNK * 4
                else:
                    out["transient_peak"] = 2 * rows * h_loc * (s / sq_div) * s * 4
        else:
            # decode: per-token scores (B, H, 1, S/model) f32 + output logits
            out["activations"] = 4 * rows * d * 2
            out["transient_peak"] = 2 * rows * hq * (s / model) * 4
    out["total"] = float(sum(v for k, v in out.items() if k != "total"))
    out["fits_hbm"] = bool(out["total"] < hbm_bytes)
    out["hbm_bytes"] = hbm_bytes
    return {k: (float(v) if not isinstance(v, bool) else v)
            for k, v in out.items()}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic 'useful' FLOPs of the step: 6·N_active·D (train) or
    2·N_active·D (inference), D = global tokens; divided by the chip count
    at report time."""
    spec = lm.model_spec(cfg)
    n_total = count_params(spec)
    if cfg.is_moe:
        # active = total - (inactive expert fraction of routed expert params).
        # Routed experts are the leaves under a ['moe'] key, not the whole
        # `*_moe` sublayer: the reference's substring test also scales the
        # sublayer's attention or Mamba and its norms (ROADMAP C16).
        e, k = cfg.n_experts, cfg.top_k
        routed = sum(int(np.prod(leaf.shape)) for keys, leaf in _spec_leaves(spec)
                     if "moe" in keys and "shared" not in keys and "router" not in keys)
        n_active = n_total - routed * (1 - k / e)
    else:
        n_active = n_total
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * tokens


def roofline(cost: dict, n_chips: int, cfg, shape) -> dict:
    """Compute and memory terms of one device's share of ``cost`` (the
    step's ``op_cost``) at the H100's datasheet rates. The collective term
    is not modelled (``None``), so ``dominant`` is compute or memory."""
    flops_dev = float(cost.get("flops", 0.0)) / n_chips
    bytes_dev = float(cost.get("traffic", 0.0)) / n_chips
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"))[1]
    mf = model_flops(cfg, shape) / n_chips
    bound = max(t_compute, t_memory)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": None,
        "dominant": dominant,
        "op_flops_per_dev": flops_dev,
        "op_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": None,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": mf / flops_dev if flops_dev else None,
        "step_time_bound_s": bound,
        "mfu_bound": mf / PEAK_FLOPS / bound if bound > 0 else None,
    }


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def _set_constraints(mesh, shape: ShapeConfig, sp: bool,
                     cfg: ModelConfig | None = None):
    """Score sharding is ALWAYS pinned for non-decode shapes; the
    Megatron-SP pair (seq-sharded residuals + gathered attention inputs)
    is the optional --sp experiment. The port records the pins
    (``shd.pinned``); its one-device models read none of them."""
    global SP_MODE
    SP_MODE = sp
    if shape.kind != "decode":
        shd.set_score_pspec(shd.default_score_pspec(
            mesh, cfg.n_heads if cfg is not None else None))
        shd.set_block_input_pspec(shd.default_attn_input_pspec(mesh))
        shd.set_decode_score_pspec(None)
    else:
        shd.set_score_pspec(None)
        shd.set_block_input_pspec(None)
        # flash-decode: scores sharded over KV-seq; never gather the cache
        shd.set_decode_score_pspec(shd.decode_score_pspec(mesh))
    if sp and shape.kind != "decode":
        seq_ok = shape.seq_len % shd._mesh_axis_sizes(mesh).get("model", 1) == 0
        shd.set_activation_pspec(shd.default_activation_pspec(mesh, seq_ok))
        shd.set_attn_input_pspec(shd.default_attn_input_pspec(mesh))
    else:
        shd.set_activation_pspec(None)
        shd.set_attn_input_pspec(None)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, top_k: int = 0,
               hbm_bytes: float = HBM_BYTES) -> dict:
    """``op_cost`` of the cell's step on ``meta`` (the whole step, not per
    device)."""
    fn, args = build_cell(cfg, shape, mesh, hbm_bytes)
    return op_cost(fn, *args, top_k=top_k)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: pathlib.Path,
             activation_sharding: bool = False, hbm_bytes: float = HBM_BYTES) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    n_chips = mesh.size
    sp = activation_sharding or (cfg.prefer_sp and shape.kind == "train")
    _set_constraints(mesh, shape, sp, cfg)
    pins = {k: None if v is None else [list(e) if isinstance(e, tuple) else e
                                       for e in v]
            for k, v in shd.pinned().items()}

    t0 = time.time()
    cost = count_cell(cfg, shape, mesh, hbm_bytes=hbm_bytes)
    t_count = time.time() - t0
    mm = memory_model(cfg, shape, mesh, hbm_bytes)
    plan = train_plan(cfg, shape, mesh, sp=sp, hbm_bytes=hbm_bytes) \
        if shape.kind == "train" else None
    _set_constraints(mesh, shape, False)

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": f"{tuple(mesh.sizes)}",
        "n_chips": n_chips,
        "kind": shape.kind,
        "count_s": round(t_count, 1),
        "pinned": pins,
        "memory": {
            "model": mm,
            "total_per_dev": mm["total"],
            "fits_hbm": mm["fits_hbm"],
            "hbm_bytes": hbm_bytes,
        },
        "cost": cost,
        "collectives": None,
        "roofline": roofline(cost, n_chips, cfg, shape),
        "plan": plan,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    out_path.write_text(json.dumps(result, indent=2))
    return result


def _run_all(args, out_dir: pathlib.Path) -> int:
    """One subprocess a cell, ``args.jobs`` at a time; cells whose JSON
    exists are skipped."""
    cells = []
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            for mesh in (("single", "multi") if args.mesh == "both" else (args.mesh,)):
                if not (out_dir / f"{arch}__{shape.name}__{mesh}.json").exists():
                    cells.append((arch, shape.name, mesh))
    print(f"{len(cells)} cells to run")
    running: list[tuple[subprocess.Popen, tuple]] = []
    failures = []
    while cells or running:
        while cells and len(running) < args.jobs:
            cell = cells.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                   "--out", str(out_dir)]
            if args.sp:
                cmd.append("--sp")
            running.append((subprocess.Popen(cmd), cell))
        done = [(p, c) for p, c in running if p.poll() is not None]
        running = [(p, c) for p, c in running if p.poll() is None]
        for p, c in done:
            status = "ok" if p.returncode == 0 else f"FAIL rc={p.returncode}"
            print(f"[{time.strftime('%H:%M:%S')}] {c} -> {status}", flush=True)
            if p.returncode != 0:
                failures.append(c)
        time.sleep(2)
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--sp", action="store_true",
                    help="seq-shard activations + constrain scores")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.all:
        return _run_all(args, out_dir)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    res = run_cell(args.arch, args.shape, args.mesh, out_dir,
                   activation_sharding=args.sp)
    r = res["roofline"]
    print(json.dumps({
        "cell": f"{args.arch} x {args.shape} x {args.mesh}",
        "fits": res["memory"]["fits_hbm"],
        "mem_GB": round(res["memory"]["total_per_dev"] / 1e9, 2),
        "dominant": r["dominant"],
        "t_compute_ms": round(r["t_compute_s"] * 1e3, 3),
        "t_memory_ms": round(r["t_memory_s"] * 1e3, 3),
        "t_collective_ms": None,
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
