"""Shared model primitives: params maker, norms, rope, attention, MLP.

The PyTorch counterpart of ``repro/models/layers.py``.  Every ``init_*`` function takes a
``Maker``; the same code path produces real tensors (mode="init") or meta
tensors that carry shape and dtype only (mode="shape", nothing
allocated).  Layouts are the reference's: ``wq`` is (d, H*hd), caches are
(B, Smax, KV, hd), so params converted from the JAX package compute the
same function here.

The reference's ``shard(...)`` annotations are kept at its call sites:
with no mesh active, or on plain tensors, each is the identity; under a
mesh (``distributed.sharding.axis_rules``) on DTensors it redistributes to
the logical axes' placements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (distribute, is_dtensor,
                                              reshape, shard, shard_heads,
                                              sharding_for)
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
    reference's ``(normal * s).astype(dtype)``.  Mode "axes" returns the
    logical axes string, with a ``"- "`` (replicated) entry per stacked
    layer axis, as the reference's stacked groups.  With a ``mesh``, an
    "init" tensor is drawn whole, in the order and from the stream of the
    unsharded init, and each rank keeps its piece of it as a DTensor
    placed by its axes (``sharding_for``)."""
    mode: str                                   # "init" | "shape" | "axes"
    generator: Optional[torch.Generator] = None
    device: Any = "cuda"
    lead: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    mesh: Any = None

    def __call__(self, shape: Tuple[int, ...], axes: str,
                 init: str = "normal", scale: float = 0.02):
        full = tuple(self.lead) + tuple(shape)
        if self.mode == "axes":
            return "- " * len(self.lead) + axes
        if self.mode == "shape":
            return torch.empty(full, dtype=self.dtype, device="meta")
        if self.mode != "init":
            raise ValueError(f"Maker mode {self.mode!r}")
        t = self._draw(full, shape, init, scale)
        if self.mesh is None:
            return t
        return distribute(t, sharding_for("- " * len(self.lead) + axes,
                                          full, self.mesh))

    def _draw(self, full, shape, init, scale) -> torch.Tensor:
        if init == "zeros":
            return torch.zeros(full, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=self.dtype, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            s = min(scale, (1.0 / fan_in) ** 0.5) if len(shape) > 1 else scale
            if full[0] > 1 and math.prod(full) > _DRAW_LIMIT:
                # drawn slice by slice along the first axis, so a bf16
                # param never has a whole f32 twin (kimi-k2's expert
                # stacks are 22 GB in f32); the slicing depends on the
                # shape alone, so the bf16 param is still the cast of the
                # f32 one of the same seed
                out = torch.empty(full, dtype=self.dtype, device=self.device)
                step = max(1, _DRAW_LIMIT // math.prod(full[1:]))
                for i in range(0, full[0], step):
                    n = min(step, full[0] - i)
                    t = torch.randn((n,) + full[1:], generator=self.generator,
                                    dtype=torch.float32, device=self.device)
                    out[i:i + n] = t.mul_(s)
                return out
            t = torch.randn(full, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            return t.mul_(s).to(self.dtype)
        raise ValueError(init)


# largest normal draw made in one piece, in elements (1 GiB of f32)
_DRAW_LIMIT = 1 << 28


# --------------------------------------------------------------------------
# embedding lookup
# --------------------------------------------------------------------------


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh (a DTensor table) a vocab-parallel
    lookup in a ``local_map`` region, as GSPMD partitions the reference's
    gather: the table gathered over its non-vocab axes, each rank of the
    vocab (``model``) axis looking up the ids in its own rows (the others
    masked to 0), the output ``Partial`` over that axis; the table's
    gradient is ``Partial`` over the axes the ids are sharded on.  DTensor's
    own rules for an index or an embedding over a vocab-sharded table
    fail in its backward (torch 2.11)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    id_pl = (list(ids.placements) if is_dtensor(ids)
             else [Replicate()] * len(names))
    id_pl = [Replicate() if i in vocab else p for i, p in enumerate(id_pl)]
    tab_pl = [Shard(0) if i in vocab else Replicate()
              for i in range(len(names))]
    out_pl = [Partial() if i in vocab else
              Shard(p.dim) if isinstance(p, Shard) else Replicate()
              for i, p in enumerate(id_pl)]
    grad_pl = [Shard(0) if i in vocab else
               Partial() if isinstance(p, Shard) else Replicate()
               for i, p in enumerate(id_pl)]
    rank = 0
    for i in vocab:
        rank = rank * mesh.size(i) + mesh.get_local_rank(names[i])

    def body(tab, idx):
        if not vocab:
            return tab[idx]
        local = idx - rank * tab.shape[0]
        ok = (local >= 0) & (local < tab.shape[0])
        out = tab[torch.where(ok, local, torch.zeros_like(local))]
        return out * ok[..., None].to(out.dtype)
    return local_map(body, out_placements=out_pl,
                     in_placements=(tab_pl, id_pl),
                     in_grad_placements=(grad_pl, id_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


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


def init_cross_attention(cfg, mk: Maker) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H = cfg.num_heads
    ed = cfg.encoder.d_model or d
    return {
        "norm": mk((d,), "embed", init="zeros"),
        "wq": mk((d, H * hd), "fsdp heads"),
        "wk": mk((ed, H * hd), "fsdp heads"),
        "wv": mk((ed, H * hd), "fsdp heads"),
        "wo": mk((H * hd, d), "heads fsdp"),
    }


def _per_shard(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *rows: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` for DTensor ``q``: a ``local_map`` region in
    which each rank attends its own rows and heads, which needs no
    communication.  q: (B, Sq, H, .); k / v: (B, Sk, KV, .); ``rows``:
    tensors whose dim 0 is the batch (positions, masks, lengths; one of
    size-1 dim 0 broadcasts and stays whole).  The rows keep q's batch
    sharding; the heads keep q's only where KV divides by it, so each
    rank's query heads read its own KV heads (else q, k and v are
    gathered over the head axes and each of their ranks computes every
    head, as ``reshape`` gathers a split it cannot keep); every other dim
    is whole.  DTensor (torch 2.11) refuses the attention einsums' flatten of
    the batch and head dims once both are sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    heads = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    split = k.shape[2] % math.prod(mesh.size(i) for i in heads) == 0
    q_pl, kv_pl, row_pl = [], [], []
    for i, p in enumerate(q.placements):
        batch = p == Shard(0)
        q_pl.append(p if batch or (i in heads and split) else Replicate())
        kv_pl.append(q_pl[-1])
        row_pl.append(p if batch else Replicate())
    rep = [Replicate()] * mesh.ndim

    def dt(x):
        return x if is_dtensor(x) else DTensor.from_local(
            x, mesh, rep, run_check=False)
    pls = [row_pl if r.shape[0] == q.shape[0] else rep for r in rows]
    return local_map(fn, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl, *pls),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, dt(k), dt(v), *(dt(r) for r in rows))


def attention_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: (B, Sq, Sk) or
    broadcastable.  GQA via head grouping (no KV materialised repeat).
    Under a mesh each rank's own rows and heads (``_per_shard``)."""
    if is_dtensor(q):
        return _per_shard(lambda *a: attention_math(*a, scale=scale),
                          q, k, v, mask)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    qg = reshape(q, (B, Sq, KV, rep, hd)).float()
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg * scale, k.float())
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), _NEG, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.float())
    return reshape(out, (B, Sq, H, v.shape[-1])).to(q.dtype)


# threshold above which attention switches to the blockwise (flash-style)
# path: never materialise an (Sq, Sk) logits tensor past this size.
_DIRECT_LIMIT = 1 << 21

# Execution options of the blockwise path, module state as in the
# reference:
#   probs_dtype — dtype the softmax weights are rounded to before the PV
#     product (which sums in f32); statistics (m, l) always stay f32.
#   block_q/block_k — the blocks of the two loops.
ATTN_OPTIONS = {"probs_dtype": torch.float32, "block_q": 512,
                "block_k": 1024}


def set_attention_options(probs_dtype=None, block_q=None, block_k=None):
    if probs_dtype is not None:
        ATTN_OPTIONS["probs_dtype"] = (
            torch.bfloat16 if str(probs_dtype).split(".")[-1] in (
                "bf16", "bfloat16") else torch.float32)
    if block_q is not None:
        ATTN_OPTIONS["block_q"] = int(block_q)
    if block_k is not None:
        ATTN_OPTIONS["block_k"] = int(block_k)


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
    memory O(block_q x block_k) per head.  Under a mesh each rank's own
    rows and heads (``_per_shard``).
    """
    if is_dtensor(q):
        # per-row lengths are rows too; an int or None rides along as is
        vt = (valid,) if torch.is_tensor(valid) else ()
        return _per_shard(lambda qq, kk, vv, qp, kp, *vl: attention_core(
            qq, kk, vv, qp, kp, vl[0] if vl else valid, causal, window,
            block_q, block_k, scale), q, k, v, qpos, kpos, *vt)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    block_q = block_q or ATTN_OPTIONS["block_q"]
    block_k = block_k or ATTN_OPTIONS["block_k"]
    pdt = ATTN_OPTIONS["probs_dtype"]

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
        qblk = reshape(q[:, i:i + bq], (B, bq, KV, rep, hd)).float() * scale
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
            # the product of ``pdt`` operands, summed in f32
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p.to(pdt).float(),
                v[:, j:j + bk].to(pdt).float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(reshape(out.permute(0, 3, 1, 2, 4), (B, bq, H, hv)))
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


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor,
                      positions: torch.Tensor, kv_len, window, causal: bool,
                      backend: str) -> torch.Tensor:
    """Write the new keys and values ``k`` / ``v`` (B, S, KV, hd) into the
    cache's ``ck`` / ``cv`` (B, Smax, KV, hd) in place, then attend ``q``
    over the cache: plain tensors (under a mesh, each rank's own rows and
    KV heads, ``_cached_per_shard``).  ``kv_len`` is the cached count, an
    int for every row or a (B,) integer tensor of per-row counts, whose
    rows write at their own ``positions`` (which the caller has checked
    fit the cache)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if torch.is_tensor(kv_len):
        rows = torch.arange(B, device=q.device)[:, None]
        ck[rows, positions] = k.to(ck.dtype)
        cv[rows, positions] = v.to(cv.dtype)
        valid = kv_len + S
    else:
        start = int(kv_len or 0)
        smax = ck.shape[1]
        if start + S > smax:
            raise ValueError(f"KV cache full: {start} + {S} > {smax}")
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        valid = start + S
    if backend == "cuda" and S == 1 and window is None:
        # serving fast path: the hand-written decode kernel attends the
        # cache through strided (B, KV, Smax, hd) views, no copy
        out = decode_attention(
            q.reshape(B, KV, H // KV, hd), ck.transpose(1, 2),
            cv.transpose(1, 2),
            valid.to(torch.int32) if torch.is_tensor(valid) else
            torch.full((B,), valid, dtype=torch.int32, device=q.device),
            block_k=decode_block(ck.shape[1]))
        return out.reshape(B, S, H, hd)
    kpos = torch.arange(ck.shape[1], device=q.device).expand(B, ck.shape[1])
    return attention_core(q, ck, cv, positions, kpos, valid, causal=causal,
                          window=window)


def _cached_per_shard(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache: Params, *rows: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, cache["k"], cache["v"], *rows)`` for DTensor ``q``: a
    ``local_map`` region in which each rank writes its own rows and KV
    heads of the cache in place and attends them, which needs no
    communication.  The cache enters as it is placed
    (``Model.cache_init(mesh=)``: rows on the batch axes, KV heads on
    ``model``; a redistributed cache would be a copy, and the writes would
    be lost); q, k and v are placed as it is (a KV head's ``rep`` query
    heads go with it), ``rows`` (positions, per-row lengths) as its
    batch.  DTensor would have to find a rule for the per-row write into
    a sharded cache, and the decode kernel launches on plain tensors
    only."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ck, cv = cache["k"], cache["v"]
    if not (is_dtensor(ck) and is_dtensor(cv)):
        raise TypeError("under a mesh the KV cache must be placed on it "
                        "(Model.cache_init(mesh=)): a plain cache would be "
                        "written whole on every rank")
    mesh, pl = ck.device_mesh, list(ck.placements)
    if Shard(1) in pl:
        # sharded on its sequence, as the dry run places a cache by the
        # rule kv_seq where its batch does not divide: DTensor's own ops
        # (a trace of the reference's layout; the engines' caches keep the
        # sequence whole)
        return fn(q, k, v, ck, cv, *rows)
    if list(cv.placements) != pl or any(
            p not in (Replicate(), Shard(0), Shard(2)) for p in pl):
        raise ValueError(f"KV cache placed {pl} / {list(cv.placements)}: "
                         f"the decode path takes a cache sharded on its rows "
                         f"and KV heads only (Model.cache_init(mesh=))")
    rep = [Replicate()] * mesh.ndim
    row_pl = [p if p == Shard(0) else Replicate() for p in pl]

    def dt(x):
        return x if is_dtensor(x) else DTensor.from_local(
            x, mesh, rep, run_check=False)
    pls = [row_pl if r.shape[0] == q.shape[0] else rep for r in rows]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl, pl, pl, pl, pl, *pls),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, dt(k), dt(v), ck, cv, *(dt(r) for r in rows))


def apply_attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window=None, cache: Optional[Params] = None,
                    kv_len=None, backend: str = "cuda",
                    causal: bool = True) -> Tuple[torch.Tensor,
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
    q = shard_heads(q, (B, S, H, hd), "batch", None, "heads", None)
    k = shard_heads(k, (B, S, KV, hd), "batch", None, "kv_heads", None)
    v = shard_heads(v, (B, S, KV, hd), "batch", None, "kv_heads", None)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_core(q, k, v, positions, positions, None,
                             causal=causal, window=window)
    else:
        def attend(q, k, v, ck, cv, positions, *lens):
            return _cached_attention(q, k, v, ck, cv, positions,
                                     lens[0] if lens else kv_len, window,
                                     causal, backend)
        if is_dtensor(q):
            lens = (kv_len,) if torch.is_tensor(kv_len) else ()
            out = _cached_per_shard(attend, q, k, v, cache, positions, *lens)
        else:
            out = attend(q, k, v, cache["k"], cache["v"], positions)
    out = reshape(out, (B, S, H * hd)) @ p["wo"]
    return x + shard(out, "batch", None, None), cache


def apply_cross_attention(p: Params, x: torch.Tensor, cfg,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor]
                          ) -> torch.Tensor:
    """Decoder cross-attention; enc_kv = (k, v): (B, Senc, H, hd)."""
    B, S, d = x.shape
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = reshape(h @ p["wq"], (B, S, H, hd))
    k, v = enc_kv
    m = torch.ones((B, S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = attention_math(q, k, v, m)
    return x + reshape(out, (B, S, H * hd)) @ p["wo"]


def cross_kv(p: Params, cfg, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Se, _ = enc_out.shape
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    # the reference's products promote: f32 encoder output, bf16 weights
    k = reshape(enc_out @ p["wk"].to(enc_out.dtype), (B, Se, H, hd))
    v = reshape(enc_out @ p["wv"].to(enc_out.dtype), (B, Se, H, hd))
    return k, v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def init_mlp(cfg, mk: Maker, ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = ff or cfg.d_ff
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
        hidden = shard(act(h @ p["w_gate"]) * (h @ p["w_up"]),
                       "batch", None, "ff")
    else:
        hidden = shard(_gelu(h @ p["w_up"]), "batch", None, "ff")
    return x + shard(hidden @ p["w_down"], "batch", None, None)
