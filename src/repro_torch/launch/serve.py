"""Serving: a batched prefill + decode loop; port of
``repro/launch/serve.py``. Requests arrive with prompts, are prefilled
into a shared cache, and decode in lock-step batches, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --requests 4 --gen-tokens 16 [--smoke] [--device cpu]

``main`` returns the generated tokens, (requests, gen-tokens), with the
prefill's time and the decode's time per step. Called as a function, it
also takes a ``config`` in place of ``--arch``'s (the same model with
fewer groups or experts, say) and ``params`` in place of the seeded
weights (a trained model's, say).

Every architecture serves. The frontend's stub embeddings (vision
patches, or audio frames for the encoder) are drawn after the prompts
from the same seeded generator, as the reference draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.spec import init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, config=None, params=None) -> dict:
    """``config`` (a ``ModelConfig``) replaces ``--arch``'s config, and
    ``--smoke`` still reduces it. ``params`` (a tree of tensors on the
    device, of the config's spec) replaces the weights drawn from
    ``--seed``; the prompts are drawn from it all the same."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="xlstm-350m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config if config is not None else get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if params is None:
        params = init_params(lm.model_spec(cfg), args.seed,
                             torch.float32 if args.smoke else torch.bfloat16, dev)

    rng = np.random.default_rng(args.seed)
    b, s = args.requests, args.prompt_len
    cache_len = s + args.gen_tokens
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (b, s)),
                                    dtype=torch.int32, device=dev)}
    emb_shape = (b, cfg.frontend_tokens, cfg.frontend_dim)
    if cfg.frontend_dim and not cfg.encoder_layers:
        batch["vision"] = torch.tensor(rng.standard_normal(emb_shape),
                                       dtype=torch.float32, device=dev)
    if cfg.encoder_layers:
        batch["frames"] = torch.tensor(rng.standard_normal(emb_shape),
                                       dtype=torch.float32, device=dev)

    _sync(dev)                      # the weights' initialisation done
    t0 = time.time()
    logits, cache = steps.prefill_step(params, batch, cfg=cfg, cache_len=cache_len)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.time() - t0

    out_tokens = [tok]
    t1 = time.time()
    for i in range(args.gen_tokens - 1):
        tok, logits, cache = steps.serve_step(params, cache, tok, s + i, cfg=cfg)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.time() - t1

    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"prefill {b}x{s} tokens in {t_prefill:.2f}s; "
          f"decoded {args.gen_tokens - 1} steps in {t_decode:.2f}s "
          f"({b * (args.gen_tokens - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    for r in range(min(b, 2)):
        print(f"request {r}: generated {gen[r].tolist()}")
    assert gen.shape == (b, args.gen_tokens)
    assert (gen >= 0).all() and (gen < cfg.vocab).all()
    return {"tokens": gen, "prefill_ms": t_prefill * 1e3,
            "decode_ms_per_step": t_decode * 1e3 / max(args.gen_tokens - 1, 1)}


if __name__ == "__main__":
    main()
