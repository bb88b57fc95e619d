"""Model/run configuration; port of ``repro/configs/base.py``, the same
frozen dataclasses field for field (the port keeps its own copy). One
config drives model construction and the train and serve entry points,
for every block kind below, an encoder and a modality frontend.

Block patterns: a model is ``n_layers`` layers arranged as ``n_layers //
len(block_pattern)`` repeats of ``block_pattern`` (scanned groups). Entries:

  "attn"        — global self-attention + FFN
  "attn_local"  — sliding-window self-attention + FFN (gemma2 local layers)
  "attn_moe"    — self-attention + MoE FFN
  "cross"       — cross-attention (to encoder / modality frontend) + FFN
  "mamba"       — Mamba selective-SSM block (+ FFN if d_ff > 0)
  "mamba_moe"   — Mamba block + MoE FFN
  "mlstm"       — xLSTM matrix-memory block
  "slstm"       — xLSTM scalar-memory block
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None     # default d_model // n_heads

    block_pattern: tuple[str, ...] = ("attn",)

    # --- attention ---
    rope_theta: float = 10000.0
    sliding_window: int | None = None       # for attn_local layers
    attn_softcap: float | None = None       # gemma2 logit softcapping
    final_softcap: float | None = None
    qk_norm: bool = False                   # qwen3-style q/k RMSNorm
    attn_bias: bool = False                 # qwen1.5-style qkv bias

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_layer_dense_ff: int = 0           # deepseek: dense layer 0 with this d_ff
    capacity_factor: float = 1.25
    moe_group_size: int = 2048              # GShard dispatch group (tokens)

    # --- SSM / xLSTM ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- enc-dec / multimodal frontends (stubs provide embeddings) ---
    encoder_layers: int = 0                 # >0: encoder-decoder
    frontend_tokens: int = 0                # patch/frame count of the stub
    frontend_dim: int = 0                   # stub embedding dim

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    sandwich_norm: bool = False             # gemma2 pre+post block norms
    scale_embed: bool = False               # gemma: embeddings * sqrt(d)
    activation: str = "silu"                # silu (SwiGLU) | gelu
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "bfloat16"

    # Per-arch shape policy (assignment rules).
    supports_long_context: bool = False     # run long_500k only if True
    has_decoder: bool = True
    # Measured per-arch layout preference (EXPERIMENTS §Perf): seq-sharded
    # scan carries + explicit block-input gathers + accum=1.
    prefer_sp: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so logits shard over a 16-wide TP axis (MaxText-style
        table padding); only seamless (256206) actually pads. Padded logit
        columns are masked to -inf in loss/decoding."""
        if self.vocab % 16 == 0:
            return self.vocab
        return (self.vocab + 511) // 512 * 512

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat_len = len(self.block_pattern)
        return dataclasses.replace(
            self,
            n_layers=2 * pat_len if pat_len <= 4 else pat_len,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2),
            expert_d_ff=32 if self.expert_d_ff else 0,
            first_layer_dense_ff=64 if self.first_layer_dense_ff else 0,
            # no-drop capacity: decode/prefill/full-forward agree exactly
            capacity_factor=float(max(self.n_experts, 1)),
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            sliding_window=16 if self.sliding_window else None,
            ssm_state=8,
            ssm_chunk=8,
            dtype="float32",
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what to lower and at what size."""
    name: str                # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
