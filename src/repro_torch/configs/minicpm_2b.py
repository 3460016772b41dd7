"""minicpm-2b — llama-like dense transformer trained with WSD schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753.  The WSD (warmup-stable-decay) schedule lives in
``repro.optim.schedule``; this config carries the architecture.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    mlp="gated_silu",
    tie_embeddings=True,
    supports_long_context=False,
)
