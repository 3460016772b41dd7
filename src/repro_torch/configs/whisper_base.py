"""whisper-base — encoder-decoder speech model, conv frontend STUB.

[arXiv:2212.04356; unverified]  6L encoder + 6L decoder, d_model=512,
8H (kv=8, head_dim=64), d_ff=2048 (plain GELU MLP), vocab=51865,
encoder context 1500 frames.

Per the assignment the conv/mel frontend is a stub: ``input_specs()``
provides precomputed frame embeddings (B, 1500, 512).  Decode shapes run
against the decoder with cross-attention over the (fixed) encoder output.
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    mlp="gelu",
    rope_theta=0.0,          # whisper uses learned absolute positions
    encoder=EncoderConfig(num_layers=6, context=1500, d_model=512),
    frontend="audio_frames",
    frontend_len=1500,
    supports_long_context=False,
)
