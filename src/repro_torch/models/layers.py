"""Shared model primitives: params maker, norms, rope, attention, MLP.

The PyTorch counterpart of ``repro/models/layers.py``, dense-attention
subset.  Every ``init_*`` function takes a ``Maker``; the same code path
produces real tensors (mode="init") or meta tensors that carry shape and
dtype only (mode="shape", nothing allocated).  Layouts are the reference's:
``wq`` is (d, H*hd), caches are (B, Smax, KV, hd), so params converted from
the JAX package compute the same function here.

On one device the reference's ``shard(...)`` annotations are identities,
so they are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention

Params = Dict[str, Any]

_NEG = -1e30


@dataclasses.dataclass
class Maker:
    """Parameter factory.  ``lead`` is the stacked-layer prefix of the
    shape: the tensor is ``lead + shape``, while the init scale follows the
    per-layer ``shape`` (the reference initialises each layer under
    ``jax.vmap``, so its fan-in never sees the layer axis).  Tensors are
    ``dtype``; a normal draw is made in float32 and cast, as the
    reference's ``(normal * s).astype(dtype)``."""
    mode: str                                   # "init" | "shape"
    generator: Optional[torch.Generator] = None
    device: Any = "cuda"
    lead: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def __call__(self, shape: Tuple[int, ...], axes: str,
                 init: str = "normal", scale: float = 0.02) -> torch.Tensor:
        full = tuple(self.lead) + tuple(shape)
        if self.mode == "shape":
            return torch.empty(full, dtype=self.dtype, device="meta")
        if self.mode != "init":
            raise ValueError(f"Maker mode {self.mode!r}")
        if init == "zeros":
            return torch.zeros(full, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=self.dtype, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            s = min(scale, (1.0 / fan_in) ** 0.5) if len(shape) > 1 else scale
            t = torch.randn(full, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            return t.mul_(s).to(self.dtype)
        raise ValueError(init)


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S).  Half-split
    rotation (the two halves of D, not interleaved pairs)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, windows, caches)
# --------------------------------------------------------------------------


def init_attention(cfg, mk: Maker) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    p = {
        "norm": mk((d,), "embed", init="zeros"),
        "wq": mk((d, H * hd), "fsdp heads"),
        "wk": mk((d, KV * hd), "fsdp kv_heads"),
        "wv": mk((d, KV * hd), "fsdp kv_heads"),
        "wo": mk((H * hd, d), "heads fsdp"),
    }
    if cfg.qkv_bias:
        p["bq"] = mk((H * hd,), "heads", init="zeros")
        p["bk"] = mk((KV * hd,), "kv_heads", init="zeros")
        p["bv"] = mk((KV * hd,), "kv_heads", init="zeros")
    return p


def attention_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: (B, Sq, Sk) or
    broadcastable.  GQA via head grouping (no KV materialised repeat)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Sq, KV, rep, hd).float()
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg * scale, k.float())
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), _NEG, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# threshold above which attention switches to the blockwise (flash-style)
# path: never materialise an (Sq, Sk) logits tensor past this size.
_DIRECT_LIMIT = 1 << 21
_BLOCK_Q, _BLOCK_K = 512, 1024


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   qpos: torch.Tensor, kpos: torch.Tensor,
                   valid: Optional[int], causal: bool, window,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Position-based attention that never builds a full (Sq, Sk) mask.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); qpos: (B, Sq); kpos: (B, Sk);
    ``valid``: count of valid cache entries (decode), one int for every
    row or a (B,) tensor of per-row counts, or None;
    ``window``: local attention window or None.

    Small problems take the direct path; large ones run a blockwise
    online softmax (Python loops over Q and KV blocks), keeping live
    memory O(block_q x block_k) per head.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    block_q = block_q or _BLOCK_Q
    block_k = block_k or _BLOCK_K

    def mask_for(qp, kp):                       # (B, sq) x (B, sk) -> bool
        kk = kp[:, None, :]
        qq = qp[:, :, None]
        m = torch.ones((B, qp.shape[1], kp.shape[1]), dtype=torch.bool,
                       device=q.device)
        if causal:
            m &= kk <= qq
        if window is not None:
            m &= kk > qq - window
        if torch.is_tensor(valid):
            m &= kk < valid[:, None, None]
        elif valid is not None:
            m &= kk < valid
        return m

    if Sq * Sk <= _DIRECT_LIMIT or Sq % min(block_q, Sq) or \
            Sk % min(block_k, Sk):
        return attention_math(q, k, v, mask_for(qpos, kpos), scale=scale)

    bq, bk = min(block_q, Sq), min(block_k, Sk)
    hv = v.shape[-1]
    outs = []
    for i in range(0, Sq, bq):
        qblk = q[:, i:i + bq].reshape(B, bq, KV, rep, hd).float() * scale
        qp = qpos[:, i:i + bq]
        m_run = torch.full((B, KV, rep, bq), _NEG, device=q.device)
        l_run = torch.zeros((B, KV, rep, bq), device=q.device)
        acc = torch.zeros((B, KV, rep, bq, hv), device=q.device)
        for j in range(0, Sk, bk):
            s = torch.einsum("bqgrh,bkgh->bgrqk", qblk,
                             k[:, j:j + bk].float())
            msk = mask_for(qp, kpos[:, j:j + bk])[:, None, None]
            s = torch.where(msk, s, torch.full((), _NEG, device=q.device))
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p, v[:, j:j + bk].float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hv))
    return torch.cat(outs, dim=1).to(q.dtype)


# the decode kernel's tile: cache positions per step of its in-block loop
DECODE_BLOCK = 256


def decode_block(smax: int) -> int:
    """The decode kernel's tile for an ``smax``-deep cache: the largest
    divisor of ``smax`` not above ``DECODE_BLOCK``, since the kernel, like
    the reference's, takes only tiles that divide the cache.  A depth with
    no large divisor gets small tiles: right, but slower, which is why
    the serving engines round their caches up (``cache_depth``)."""
    return max(b for b in range(1, min(DECODE_BLOCK, smax) + 1)
               if smax % b == 0)


def cache_depth(max_len: int) -> int:
    """Depth of the KV cache the serving engines allocate for ``max_len``
    positions: past one decode tile, ``max_len`` rounded up to a whole
    number of tiles, so the decode kernel always runs full-size tiles
    (``decode_block``).  A decode step always has at least one valid
    position, so the extra, never-written positions get a weight of
    exactly 0 and the tokens are those of a ``max_len``-deep cache."""
    if max_len <= DECODE_BLOCK:
        return max_len
    return -(-max_len // DECODE_BLOCK) * DECODE_BLOCK


def apply_attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window=None, cache: Optional[Params] = None,
                    kv_len=None,
                    backend: str = "cuda") -> Tuple[torch.Tensor,
                                                    Optional[Params]]:
    """Pre-norm GQA attention block with optional KV cache.

    Training/prefill: x is (B, S, d), cache None/fresh. Decode: x is
    (B, 1, d) and ``cache`` holds (B, Smax, KV, hd) buffers with ``kv_len``
    tokens valid before this call: one int for every row, or a (B,)
    integer tensor of per-row counts (the continuous engine's slots),
    whose keys and values go to each row's own positions (``positions``,
    which the caller has checked fit the cache).  Unlike the reference,
    which returns a new cache, the new keys and values are written into
    ``cache`` in place and the same dict is returned.
    """
    B, S, d = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is not None and torch.is_tensor(kv_len):
        rows = torch.arange(B, device=x.device)[:, None]
        cache["k"][rows, positions] = k.to(cache["k"].dtype)
        cache["v"][rows, positions] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        valid = kv_len + S
    elif cache is not None:
        start = int(kv_len or 0)
        smax = cache["k"].shape[1]
        if start + S > smax:
            raise ValueError(f"KV cache full: {start} + {S} > {smax}")
        cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        valid = start + S
    else:
        valid = None

    if backend == "cuda" and cache is not None and S == 1 and window is None:
        # serving fast path: the hand-written decode kernel attends the
        # cache through strided (B, KV, Smax, hd) views, no copy
        rep = H // KV
        out = decode_attention(
            q.reshape(B, KV, rep, hd), k.transpose(1, 2), v.transpose(1, 2),
            valid.to(torch.int32) if torch.is_tensor(valid) else
            torch.full((B,), valid, dtype=torch.int32, device=x.device),
            block_k=decode_block(k.shape[1]))
        out = out.reshape(B, S, H, hd)
    else:
        kpos = positions if cache is None else torch.arange(
            k.shape[1], device=x.device).expand(B, k.shape[1])
        out = attention_core(q, k, v, positions, kpos, valid, causal=True,
                             window=window)
    out = out.reshape(B, S, H * hd) @ p["wo"]
    return x + out, cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def init_mlp(cfg, mk: Maker) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"norm": mk((d,), "embed", init="zeros")}
    if cfg.mlp.startswith("gated"):
        p["w_gate"] = mk((d, ff), "fsdp ff")
        p["w_up"] = mk((d, ff), "fsdp ff")
        p["w_down"] = mk((ff, d), "ff fsdp")
    else:
        p["w_up"] = mk((d, ff), "fsdp ff")
        p["w_down"] = mk((ff, d), "ff fsdp")
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    if cfg.mlp.startswith("gated"):
        act = F.silu if cfg.mlp == "gated_silu" else _gelu
        hidden = act(h @ p["w_gate"]) * (h @ p["w_up"])
    else:
        hidden = _gelu(h @ p["w_up"])
    return x + hidden @ p["w_down"]
