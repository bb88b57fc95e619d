"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=102400; 2 shared + 64 routed top-6 fine-grained experts,
dense FFN (d_ff=10944) on layer 0 [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=27,                   # + the separate dense layer 0 (28 total)
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                        # all scanned layers are MoE
    vocab=102400,
    block_pattern=("attn_moe",),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    first_layer_dense_ff=10944,
    activation="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
    supports_long_context=False,
)
