"""gemma3-4b — dense transformer, 5 local : 1 global attention, 128k ctx.

[hf:google/gemma-3-4b-pt; unverified]  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, local window 1024.

Local/global layers share one block structure; the window is a per-layer
scalar threaded through the layer scan, so the stack still compiles as a
single homogeneous scan (no HLO branch duplication).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    pattern=("attn",),
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),   # 5 local : 1 global
    mlp="gated_gelu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    supports_long_context=True,      # dominated by windowed layers
)
