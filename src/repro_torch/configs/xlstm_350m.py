"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; alternating
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]. Recurrent O(1) decode
state => assigned long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,                  # pf=2 expansion: inner dim 2*d_model
    d_ff=0,                        # xLSTM blocks carry their own projections
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    ssm_chunk=256,
    activation="gelu",
    tie_embeddings=True,
    supports_long_context=True,
)
