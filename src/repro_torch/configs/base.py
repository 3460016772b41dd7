"""Config system: architecture + run configuration.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch/configs/``; ``get_config(name)`` resolves them by id, and
``reduced(cfg)`` derives the CPU-smoke-test variant of the same family.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    first_dense_layers: int = 0
    dense_ff: int = 0                 # ff of the leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 0                   # 0 = full-rank q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int = 0                  # 0 -> 2 * d_model
    head_dim: int = 64
    state_dim: int = 128
    conv_width: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0                    # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). The modality frontend is
    a stub per the assignment: inputs are precomputed frame embeddings."""
    num_layers: int
    context: int                      # e.g. 1500 audio frames
    d_model: int = 0                  # 0 -> same as decoder


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # per-layer block pattern, cycled over layers: entries from
    # {"attn", "moe", "rglru", "ssd"}
    pattern: Tuple[str, ...] = ("attn",)
    # per-layer local-attention window; None = global. For mixed
    # local:global archs (gemma3) use window_pattern, cycled per layer.
    window_pattern: Tuple[Optional[int], ...] = (None,)
    qkv_bias: bool = False
    mlp: str = "gated_silu"           # gated_silu | gated_gelu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None    # None | audio_frames | image_patches
    frontend_len: int = 0             # stub frames/patches prepended
    # whether the arch is sub-quadratic enough for the long_500k cell
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the embedding/logits vocab dim shards over
        the model axis (x16) and the fsdp axes (x32) — padded logit
        columns are masked to -inf in the loss/sampler."""
        mult = 512
        return (self.vocab_size + mult - 1) // mult * mult

    def layer_kinds(self) -> List[str]:
        return [self.pattern[i % len(self.pattern)]
                for i in range(self.num_layers)]

    def layer_windows(self) -> List[Optional[int]]:
        return [self.window_pattern[i % len(self.window_pattern)]
                for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # lm head
        for i, kind in enumerate(self.layer_kinds()):
            n += 2 * d                                # 2 norms
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qdim = self.num_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    n += d * qdim
                    n += d * (m.kv_lora + m.qk_rope_dim)
                    n += m.kv_lora * self.num_heads * (m.qk_nope_dim + m.v_dim)
                    n += self.num_heads * m.v_dim * d
                else:
                    n += d * self.num_heads * hd
                    n += 2 * d * self.num_kv_heads * hd
                    n += self.num_heads * hd * d
                n += self._mlp_params(i)
            elif kind == "moe":
                n += self._mlp_params(i)
            elif kind == "rglru":
                r = self.rglru or RGLRUConfig()
                w = r.width or d
                n += 2 * d * w + w * d               # in projs + out proj
                n += r.conv_width * w + 3 * w        # conv + a_param + gates
                n += 2 * w * w                       # gate linears
            elif kind == "ssd":
                s = self.ssm or SSMConfig()
                di = s.d_inner or 2 * d
                heads = di // s.head_dim
                n += d * (2 * di + 2 * s.state_dim + heads)  # in_proj
                n += s.conv_width * (di + 2 * s.state_dim)   # conv
                n += 2 * heads + di                          # A, D, norm
                n += di * d                                  # out_proj
        if self.encoder is not None:
            e = self.encoder
            ed = e.d_model or d
            per = 4 * ed * ed + 2 * ed * self.d_ff + 2 * ed  # self-attn + mlp
            n += e.num_layers * per
            # decoder cross-attention adds per-layer params
            n += self.num_layers * 4 * d * d
        return n

    def _mlp_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is not None and layer_idx >= self.moe.first_dense_layers \
                and self.layer_kinds()[layer_idx] == "moe":
            m = self.moe
            n = d * m.num_experts                     # router
            gates = 3 if self.mlp.startswith("gated") else 2
            n += m.num_experts * gates * d * m.expert_ff
            n += m.num_shared * gates * d * m.expert_ff
            return n
        ff = self.d_ff
        if self.moe is not None and layer_idx < self.moe.first_dense_layers:
            ff = self.moe.dense_ff or self.d_ff
        if self.mlp.startswith("gated"):
            return 3 * d * ff
        return 2 * d * ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        m = self.moe
        gates = 3 if self.mlp.startswith("gated") else 2
        n_moe_layers = sum(1 for i, k in enumerate(self.layer_kinds())
                           if k == "moe" and i >= m.first_dense_layers)
        all_routed = n_moe_layers * m.num_experts * gates * self.d_model * m.expert_ff
        active_routed = n_moe_layers * m.top_k * gates * self.d_model * m.expert_ff
        return total - all_routed + active_routed


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

ARCHS = (
    "recurrentgemma_2b", "qwen1_5_32b", "gemma3_4b", "minicpm_2b",
    "qwen2_7b", "mamba2_130m", "deepseek_v2_236b", "kimi_k2_1t",
    "pixtral_12b", "whisper_base",
)

_ALIASES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma3-4b": "gemma3_4b",
    "minicpm-2b": "minicpm_2b",
    "qwen2-7b": "qwen2_7b",
    "mamba2-130m": "mamba2_130m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "kimi-k2-1t": "kimi_k2_1t",
    "pixtral-12b": "pixtral_12b",
    "whisper-base": "whisper_base",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} "
                       f"(aliases: {sorted(_ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    pat = len(cfg.pattern)
    layers = max(layers, pat)          # at least one full pattern
    heads = max(2, min(cfg.num_heads, 4))
    kv = 1 if cfg.num_kv_heads == 1 else max(1, min(cfg.num_kv_heads, heads))
    hd = max(8, d_model // heads)
    changes: Dict = dict(
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, head_dim=hd, d_ff=d_model * 2,
        vocab_size=vocab, frontend_len=min(cfg.frontend_len, 8),
        window_pattern=tuple(None if w is None else min(w, 8)
                             for w in cfg.window_pattern),
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, expert_ff=d_model,
            dense_ff=d_model * 2)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora=16, qk_nope_dim=8, qk_rope_dim=8,
                                   v_dim=8)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_inner=2 * d_model, head_dim=16, state_dim=16, chunk=8)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, width=d_model)
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(num_layers=2, context=16,
                                           d_model=d_model)
    return dataclasses.replace(cfg, **changes)
