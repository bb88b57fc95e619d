"""seamless-m4t-large-v2 [audio] — enc-dec, 24L(+24L enc) d_model=1024 16H
(MHA kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]. The speech
frontend is a STUB: input_specs provides precomputed frame embeddings
(B, 1024 frames, 1024) consumed by the encoder; the decoder cross-attends
to encoder output."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    block_pattern=("attn", "cross"),   # 12 repeats: self+cross decoder pairs
    encoder_layers=24,
    frontend_tokens=1024,
    frontend_dim=1024,
    activation="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
    supports_long_context=False,
)
