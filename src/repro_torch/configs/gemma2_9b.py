"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]. long_500k skipped: global layers are full attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,                 # gemma2 uses 256, not d_model/heads
    d_ff=14336,
    vocab=256000,
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    supports_long_context=False,
)
