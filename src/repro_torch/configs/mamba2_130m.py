"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  24L d_model=768, d_inner=1536,
head_dim=64 (24 heads), ssm_state=128, vocab=50280.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # SSD heads = d_inner / head_dim
    num_kv_heads=24,
    d_ff=0,                  # attention-free, no separate MLP block
    vocab_size=50_280,
    pattern=("ssd",),
    tie_embeddings=True,
    ssm=SSMConfig(d_inner=1536, head_dim=64, state_dim=128, conv_width=4,
                  chunk=64),
    supports_long_context=True,   # linear-time recurrence
)
