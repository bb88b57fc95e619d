#!/usr/bin/env python3
"""Where a decode step of a served LM goes on the card.

    python3 tools/profile_lm_decode.py [--arch deepseek-moe-16b] [--seed 0]
        [--requests 4] [--prompt-len 32]

Builds the architecture at full size in bf16, as
``repro_torch.launch.serve`` does, prefills ``--requests`` prompts twice
(the first call warms up), decodes three steps timed on the host clock
to a synchronize, then two steps under ``torch.profiler``: the kernel
launches (``cudaLaunchKernel`` and ``cuLaunchKernelEx`` calls), the
summed host and device time, and the operators and kernels with the
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
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_lm_decode: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_identity
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params

    card = card_identity()
    cfg = get_config(args.arch)
    t0 = time.perf_counter()
    params = init_params(lm.model_spec(cfg), args.seed, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"{args.arch}: init {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len), device="cuda",
                         dtype=torch.int32, generator=gen)
    cache_len = args.prompt_len + 16
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = steps.prefill_step(params, {"tokens": toks}, cfg=cfg,
                                      cache_len=cache_len)
        torch.cuda.synchronize()
        print(f"prefill {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})", flush=True)
    tok = toks[:, -1:]
    pos = args.prompt_len
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, cache = steps.serve_step(params, cache, tok, pos, cfg=cfg)
        torch.cuda.synchronize()
        pos += 1
        print(f"decode {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tok, _, cache = steps.serve_step(params, cache, tok, pos, cfg=cfg)
            pos += 1
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    print(f"two decode steps under the profiler: {launches} launches; ({card})", flush=True)
    print(ka.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    print(ka.table(sort_by="cpu_time_total", row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
