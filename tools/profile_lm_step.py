#!/usr/bin/env python3
"""Where a train step of an LM (xlstm-350m by default) goes on the card.

    python3 tools/profile_lm_step.py [--arch xlstm-350m] [--seed 0] [--batch 8]
        [--seq 128]

Builds the architecture at full width and depth in bf16 with float32
moments, as ``repro_torch.launch.train`` does, runs two warm-up steps on
one ``SyntheticTokens`` batch (with the frontend's frames where the
architecture has one), then prints the step's, ``value_and_grad``'s
and the forward's host-clock times, and one step under
``torch.profiler``: its wall time, the summed device time and the
device's idle share, the kernel launches (``cudaLaunchKernel`` calls),
and the operators and kernels with the most host and device time. Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_lm_step: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import card_identity
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params
    from repro_torch.optim import adamw
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30,
                              moment_dtype="float32")
    params = init_params(lm.model_spec(cfg), args.seed, torch.bfloat16, "cuda")
    state = steps.TrainState(params, adamw.init_opt_state(opt_cfg, params))
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                       global_batch=args.batch, seed=args.seed,
                                       frontend_tokens=cfg.frontend_tokens,
                                       frontend_dim=cfg.frontend_dim),
                            device="cuda").batch_at(0)

    def step():
        return steps.train_step(state, batch, cfg=cfg, opt_cfg=opt_cfg)

    def ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    step()
    print(f"card: {card_identity()}")
    print(f"train step {ms(step):.1f} ms, value_and_grad "
          f"{ms(lambda: steps.value_and_grad(state.params, cfg, batch)):.1f} ms")
    with torch.no_grad():
        print(f"forward (train_loss, no autograd) "
              f"{ms(lambda: lm.train_loss(state.params, cfg, batch)):.1f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel")
    print(f"profiled step wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1 - busy / wall:.3f}, {launches} kernel launches")
    ops = sorted((e for e in averages if e.device_type != DeviceType.CUDA),
                 key=lambda e: e.cpu_time_total, reverse=True)
    print("host time (ms, with children) by operator:")
    for e in ops[:12]:
        print(f"{e.cpu_time_total / 1e3:12.3f} ms  x{e.count:6d}  {e.key[:90]}")
    print("device time by kernel:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"{dev_us(e) / 1e3:12.3f} ms  x{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
