"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8,
head_dim=128), MoE: 384 routed experts top-8 + 1 shared, expert
d_ff=2048, first layer dense (d_ff=18432), vocab=163840.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,               # routed expert intermediate
    vocab_size=163_840,
    pattern=("moe",),
    mlp="gated_silu",
    moe=MoEConfig(num_experts=384, top_k=8, expert_ff=2048, num_shared=1,
                  first_dense_layers=1, dense_ff=18432,
                  capacity_factor=1.25),
    supports_long_context=False,
)
