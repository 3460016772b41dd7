"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H
(GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.

Per the assignment the vision frontend is a stub: ``input_specs()``
provides precomputed patch embeddings (B, frontend_len, d_model) which
replace the first ``frontend_len`` token embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    mlp="gated_silu",
    frontend="image_patches",
    frontend_len=1024,       # one 1024-patch image per sequence (stub)
    supports_long_context=False,
)
