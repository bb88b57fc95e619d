"""Data; port of ``repro/data/pipeline.py``: the point-cloud helpers
(numpy in, numpy out) and the deterministic synthetic token stream of the
LM stack.

``SyntheticTokens.batch_at(step)`` is a pure function of (seed, step),
so resume after a restart is exact (the checkpoint stores only the step).
It draws with numpy exactly as the reference does, so both packages see
the very same batches; the port hands them out as tensors on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "SyntheticTokens", "make_clustered_points",
           "hacc_benchmark_epsilon"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0


class SyntheticTokens:
    """Seekable deterministic token stream: a Zipf unigram skeleton with a
    deterministic bigram rule on half the positions, so that a model can
    learn it. Batches come out on ``device`` (``None``: the CUDA card;
    raises without one)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()
        self._shift = rng.integers(1, 97)

    def _host_slice(self, host_index: int, host_count: int) -> tuple[int, int]:
        per = self.cfg.global_batch // host_count
        return host_index * per, per

    def batch_at(self, step: int, host_index: int = 0, host_count: int = 1) -> dict:
        """Global batch for a step (or this host's rows): tokens and labels
        (rows, seq_len) int32 and an all-true loss mask; with a frontend,
        its stub's embeddings (rows, frontend_tokens, frontend_dim) f32,
        one tensor under both ``frames`` and ``vision``."""
        cfg = self.cfg
        start, rows = self._host_slice(host_index, host_count)
        toks = np.empty((rows, cfg.seq_len + 1), np.int32)
        for r in range(rows):
            rrng = np.random.default_rng((cfg.seed, step, start + r))
            base = rrng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self._probs)
            # half the positions follow the deterministic bigram rule
            mask = rrng.random(cfg.seq_len) < 0.5
            nxt = (base[:-1] + self._shift) % cfg.vocab
            base[1:] = np.where(mask, nxt, base[1:])
            toks[r] = base
        toks = torch.from_numpy(toks).to(self.device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "loss_mask": torch.ones((rows, cfg.seq_len), dtype=torch.bool,
                                         device=self.device)}
        if cfg.frontend_dim:
            frng = np.random.default_rng((cfg.seed, step, 77))
            emb = frng.standard_normal(
                (rows, cfg.frontend_tokens, cfg.frontend_dim), np.float32)
            batch["frames"] = torch.from_numpy(emb).to(self.device)
            batch["vision"] = batch["frames"]
        return batch


def make_clustered_points(rng: np.random.Generator, n: int, d: int = 3,
                          n_halos: int = 32, noise_frac: float = 0.2,
                          halo_scale: float = 0.05) -> np.ndarray:
    """NFW-like halo profiles + uniform background in [0,1)^d; the same
    draws from ``rng`` as the reference, so one seed gives one cloud."""
    n_noise = int(n * noise_frac)
    n_clustered = n - n_noise
    centers = rng.uniform(0.05, 0.95, (n_halos, d))
    w = rng.pareto(1.5, n_halos) + 1
    sizes = rng.multinomial(n_clustered, w / w.sum())
    parts = [rng.uniform(0.0, 1.0, (n_noise, d)).astype(np.float32)]
    for c, s in zip(centers, sizes):
        if s == 0:
            continue
        u = rng.uniform(0, 1, (s, 1)) ** 2.5
        direction = rng.standard_normal((s, d))
        direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-9)
        r = halo_scale * u * (0.3 + rng.uniform(0, 1, (n_halos,))[0])
        # N-body particles never coincide: a floor on the radius.
        r = np.maximum(r, 5e-5)
        parts.append((c + r * direction).astype(np.float32))
    pts = np.concatenate(parts)
    return np.clip(pts, 0.0, 1.0 - 1e-6).astype(np.float32)


def hacc_benchmark_epsilon(volume: float, n_particles: int, b: float = 0.168) -> float:
    """The paper's linking length: ε = b (V/n)^{1/3}."""
    return b * (volume / n_particles) ** (1.0 / 3.0)
