"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf]  60L d_model=5120 128H, MLA kv_lora=512
(qk_nope=128, qk_rope=64, v=128), MoE: 160 routed experts top-6 +
2 shared, expert d_ff=1536, first layer dense (d_ff=12288),
vocab=102400.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: per-head KV reconstructed from the latent
    head_dim=128,
    d_ff=1536,               # routed expert intermediate
    vocab_size=102_400,
    pattern=("moe",),
    mlp="gated_silu",
    moe=MoEConfig(num_experts=160, top_k=6, expert_ff=1536, num_shared=2,
                  first_dense_layers=1, dense_ff=12288,
                  capacity_factor=1.25),
    mla=MLAConfig(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    supports_long_context=False,
)
