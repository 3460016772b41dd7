"""Multi-head Latent Attention (deepseek-v2).

The PyTorch counterpart of ``repro/models/mla.py``.  The KV cache stores
only the compressed latent ``ckv`` (kv_lora wide) and the shared rope key
``kr``.  Without a cache (a full forward) per-head K/V are reconstructed
from the latent; on cached paths (prefill into a cache, decode) the
absorbed form attends in latent space: W_uk folded into the query makes
MLA an MQA with one KV head of width kv_lora + qk_rope.
``set_mla_absorbed(False)`` forces the reconstruct form everywhere.

As in ``layers.apply_attention``, a cache is written in place at the
positions its ``kv_len`` gives (an int for every row, or a (B,) integer
tensor of per-row lengths) and the same dict is returned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import reshape, shard
from repro_torch.models.layers import (Maker, Params, attention_core,
                                       rmsnorm, rope)

# absorbed (latent-MQA) attention on cached paths; False forces the
# reconstruct-then-attend form, as in the reference
_ABSORBED = True


def set_mla_absorbed(on: bool) -> None:
    global _ABSORBED
    _ABSORBED = bool(on)


def init_mla(cfg, mk: Maker) -> Params:
    d = cfg.d_model
    a = cfg.mla
    H = cfg.num_heads
    qd = a.qk_nope_dim + a.qk_rope_dim
    return {
        "norm": mk((d,), "embed", init="zeros"),
        "wq": mk((d, H * qd), "fsdp heads"),
        "w_dkv": mk((d, a.kv_lora + a.qk_rope_dim), "fsdp embed"),
        "kv_norm": mk((a.kv_lora,), "embed", init="zeros"),
        "w_ukv": mk((a.kv_lora, H * (a.qk_nope_dim + a.v_dim)), "fsdp heads"),
        "wo": mk((H * a.v_dim, d), "heads fsdp"),
    }


def apply_mla(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
              cache: Optional[Params] = None, kv_len=None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    B, S, d = x.shape
    a = cfg.mla
    H = cfg.num_heads
    nope, rdim, vdim = a.qk_nope_dim, a.qk_rope_dim, a.v_dim

    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = reshape(h @ p["wq"], (B, S, H, nope + rdim))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    dkv = h @ p["w_dkv"]
    c_kv = rmsnorm(dkv[..., :a.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(dkv[..., None, a.kv_lora:], positions,
                  cfg.rope_theta)[:, :, 0]

    if cache is not None and torch.is_tensor(kv_len):
        rows = torch.arange(B, device=x.device)[:, None]
        cache["ckv"][rows, positions] = c_kv.to(cache["ckv"].dtype)
        cache["kr"][rows, positions] = k_rope.to(cache["kr"].dtype)
        valid = kv_len + S
    elif cache is not None:
        start = int(kv_len or 0)
        smax = cache["ckv"].shape[1]
        if start + S > smax:
            raise ValueError(f"KV cache full: {start} + {S} > {smax}")
        cache["ckv"][:, start:start + S] = c_kv.to(cache["ckv"].dtype)
        cache["kr"][:, start:start + S] = k_rope.to(cache["kr"].dtype)
        valid = start + S
    if cache is not None:
        c_kv, k_rope = cache["ckv"], cache["kr"]
        kpos = torch.arange(c_kv.shape[1], device=x.device).expand(
            B, c_kv.shape[1])
    else:
        kpos, valid = positions, None

    Sk = c_kv.shape[1]
    if cache is not None and _ABSORBED:
        # attend in latent space; the logits equal the reconstruct form's
        # by associativity, so the scale stays 1/sqrt(nope + rope)
        w_ukv = p["w_ukv"].reshape(a.kv_lora, H, nope + vdim)
        w_uk = w_ukv[..., :nope]                        # (lora, H, nope)
        w_uv = w_ukv[..., nope:]                        # (lora, H, v)
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
        qq = torch.cat([q_lat, q_rope], dim=-1)         # (B,S,H,lora+rope)
        k_eff = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
        v_eff = c_kv[:, :, None, :]                     # (B,Sk,1,lora)
        qq = shard(qq, "batch", None, "heads", None)
        ctx = attention_core(qq, k_eff, v_eff, positions, kpos, valid,
                             causal=True, window=None,
                             scale=1.0 / float((nope + rdim) ** 0.5))
        out = torch.einsum("bshl,lhv->bshv", ctx, w_uv)
    else:
        kv = reshape(c_kv @ p["w_ukv"], (B, Sk, H, nope + vdim))
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, H, rdim)],
                      dim=-1)
        qq = shard(torch.cat([q_nope, q_rope], dim=-1),
                   "batch", None, "heads", None)
        k = shard(k, "batch", None, "heads", None)
        v = shard(v, "batch", None, "heads", None)
        out = attention_core(qq, k, v, positions, kpos, valid, causal=True,
                             window=None)
    out = reshape(out, (B, S, H * vdim)) @ p["wo"]
    return x + shard(out, "batch", None, None), cache
