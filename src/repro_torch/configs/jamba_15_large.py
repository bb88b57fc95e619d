"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; Mamba:attention 1:7 interleave, MoE 16 experts
top-2 on every other layer [arXiv:2403.19887; hf]. Mamba-majority =>
assigned long_500k (the 9 attention layers use the seq-sharded KV cache)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    # 8-layer Jamba block: attn at index 0 (1:7), MoE on odd layers.
    block_pattern=("attn", "mamba_moe", "mamba", "mamba_moe",
                   "mamba", "mamba_moe", "mamba", "mamba_moe"),
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    expert_d_ff=24576,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=256,
    activation="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
    supports_long_context=True,
    prefer_sp=True,   # measured: collectives -14%, HBM traffic -42% (§Perf)
)
