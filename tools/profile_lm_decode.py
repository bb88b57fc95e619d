#!/usr/bin/env python3
"""Where a decode step (or a prefill) of a served LM goes on the card.

    python3 tools/profile_lm_decode.py [--arch deepseek-moe-16b] [--seed 0]
        [--requests 4] [--prompt-len 32] [--layers N] [--experts E] [--prefill]

Builds the architecture at full width in bf16, as
``repro_torch.launch.serve`` does (``--layers`` and ``--experts`` cut its
depth and its experts, as jamba-1.5-large needs to fit; the frontend's
embeddings are drawn from the seed), prefills ``--requests`` prompts
twice (the first call warms up), decodes three steps timed on the host
clock to a synchronize, then two steps (``--prefill``: one more prefill)
under ``torch.profiler``: the kernel launches (``cudaLaunchKernel`` and
``cuLaunchKernelEx`` calls), the summed device time of the kernels
against the host's wall time, and the operators and kernels with the
most of each. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None, help="n_layers (default: the config's)")
    ap.add_argument("--experts", type=int, default=None, help="n_experts (default: the config's)")
    ap.add_argument("--prefill", action="store_true", help="profile a prefill, not decode steps")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_lm_decode: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_identity
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params

    card = card_identity()
    cfg = get_config(args.arch)
    cut = {k: v for k, v in (("n_layers", args.layers), ("n_experts", args.experts)) if v}
    cfg = cfg.scaled(**cut)
    t0 = time.perf_counter()
    params = init_params(lm.model_spec(cfg), args.seed, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"{args.arch}: init {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len), device="cuda",
                         dtype=torch.int32, generator=gen)
    batch = {"tokens": toks}
    if cfg.frontend_dim:
        batch["frames"] = batch["vision"] = torch.randn(
            (args.requests, cfg.frontend_tokens, cfg.frontend_dim), device="cuda",
            generator=gen)
    cache_len = args.prompt_len + 16
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = steps.prefill_step(params, batch, cfg=cfg, cache_len=cache_len)
        torch.cuda.synchronize()
        print(f"prefill {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})", flush=True)
    what = "one prefill" if args.prefill else "two decode steps"
    tok = toks[:, -1:]
    pos = args.prompt_len
    for _ in range(0 if args.prefill else 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, cache = steps.serve_step(params, cache, tok, pos, cfg=cfg)
        torch.cuda.synchronize()
        pos += 1
        print(f"decode {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.prefill:
            steps.prefill_step(params, batch, cfg=cfg, cache_len=cache_len)
        for _ in range(0 if args.prefill else 2):
            tok, _, cache = steps.serve_step(params, cache, tok, pos, cfg=cfg)
            pos += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    busy = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e3
    print(f"{what} under the profiler: {launches} launches; kernels {busy:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall ({card})", flush=True)
    print(ka.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    print(ka.table(sort_by="cpu_time_total", row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
