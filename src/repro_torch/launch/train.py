"""End-to-end training loop; port of ``repro/launch/train.py``.

A real training loop on the card: synthetic deterministic data, AdamW,
async checkpoints under the supervisor, the straggler watchdog, and the
in-situ analysis (embedding and router clustering on the traversal and
segment kernels) at its cadence.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --steps 100 --ckpt-dir CKPT_DIR [--smoke] [--device cpu]

A checkpoint directory that holds a committed step resumes from it.
Called as a function, ``main`` also takes the supervisor's ``fault_hook``,
a span tracer for the analyses and a ``config`` in place of ``--arch``'s
(the same model with fewer groups, say), and returns the final state,
the logged losses, the analyses' history and the supervisor (its
per-step times are in ``supervisor.stats``).

Every architecture trains; the batches of those with a frontend carry
its stub's embeddings (``SyntheticTokens``' frames).
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import tempfile
import time

import torch

from repro_torch.analysis.insitu import InsituAnalyzer, InsituConfig
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.spec import init_params
from repro_torch.optim import adamw
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig


def main(argv=None, *, fault_hook=None, tracer=None, config=None) -> dict:
    """``fault_hook(step)`` runs before each step and may raise to simulate
    a failure (``Supervisor.run``); ``tracer`` (a
    ``repro_torch.obs.SpanTracer``) records each analysis's spans;
    ``config`` (a ``ModelConfig``) replaces ``--arch``'s config, and
    ``--smoke`` still reduces it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="xlstm-350m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--insitu-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dev = resolve_device(args.device)
    cfg = config if config is not None else get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    spec = lm.model_spec(cfg)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                              total_steps=args.steps, moment_dtype="float32")
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend_tokens=cfg.frontend_tokens,
        frontend_dim=cfg.frontend_dim), device=dev)

    def init_state():
        params = init_params(spec, args.seed,
                             torch.float32 if args.smoke else torch.bfloat16, dev)
        return steps.TrainState(params, adamw.init_opt_state(opt_cfg, params))

    step = functools.partial(steps.train_step, cfg=cfg, opt_cfg=opt_cfg)
    analyzer = InsituAnalyzer(InsituConfig(cadence=args.insitu_every), tracer,
                              device=dev)
    losses: list[float] = []

    def step_fn(state, i):
        state, metrics = step(state, data.batch_at(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        insitu = analyzer.maybe_run(state.params, i)
        if insitu:
            print(f"step {i:5d} insitu {json.dumps(insitu)}", flush=True)
        return state, metrics

    sup = Supervisor(SupervisorConfig(total_steps=args.steps,
                                      checkpoint_every=args.ckpt_every),
                     CheckpointStore(args.ckpt_dir))
    t0 = time.time()
    state = sup.run(init_state_fn=init_state, step_fn=step_fn,
                    fault_hook=fault_hook)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s); "
          f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not improve"
    return {"state": state, "losses": losses, "insitu": analyzer.history,
            "supervisor": sup}


if __name__ == "__main__":
    main()
