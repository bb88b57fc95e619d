"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. The vision tower is a
STUB per the assignment: input_specs provides precomputed patch embeddings
(B, 1601, 7680) fed through frontend_proj."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    # 8 repeats of [self, self, self, cross, self] = cross at 3, 8, 13, ...
    block_pattern=("attn", "attn", "attn", "cross", "attn"),
    frontend_tokens=1601,
    frontend_dim=7680,
    activation="silu",
    tie_embeddings=False,
    rope_theta=500000.0,
    supports_long_context=False,
)
