"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936; 128 routed experts top-8, QK-norm
[hf:Qwen/Qwen3-30B-A3B family; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    block_pattern=("attn_moe",),
    n_experts=128,
    n_shared_experts=0,
    top_k=8,
    expert_d_ff=1536,
    qk_norm=True,
    activation="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    supports_long_context=False,
    prefer_sp=True,   # measured: collectives -43% vs accum-16 baseline
)
