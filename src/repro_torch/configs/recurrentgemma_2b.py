"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, local-attention window 2048, pattern (rglru, rglru, attn).
"""

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "attn"),
    window_pattern=(2048,),
    mlp="gated_gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(width=2560, conv_width=4, c=8.0),
    supports_long_context=True,      # recurrence + windowed attention
)
