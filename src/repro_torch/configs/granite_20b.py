"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    block_pattern=("attn",),
    activation="gelu",             # GPT-BigCode-style non-gated MLP => 20B
    tie_embeddings=True,
    rope_theta=10000.0,
    supports_long_context=False,
)
