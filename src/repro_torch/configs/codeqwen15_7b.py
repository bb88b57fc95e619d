"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 = MHA)
d_ff=13440 vocab=92416; qwen1.5 arch (attention QKV bias)
[hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    block_pattern=("attn",),
    attn_bias=True,
    activation="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    supports_long_context=False,
)
