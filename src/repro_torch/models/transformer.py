"""Architecture-generic transformer stack.

The PyTorch counterpart of ``repro/models/transformer.py``.  Layers are
grouped by the config's cyclic ``pattern`` exactly as in the reference, so
the param and cache trees have the same keys and layouts: the repeated
groups are stacked along a leading layer axis under ``params["scan"]``.
Where the reference runs ``lax.scan`` over that axis, the port runs a
Python loop over it; a non-conforming prefix (deepseek's and kimi-k2's
leading dense layer) or suffix (recurrentgemma's trailing recurrent pair)
is unrolled around the groups under ``prefix`` / ``suffix``, keyed by
layer index.

Every layer kind of the registry is ported: ``attn``, ``dense_moe``,
``moe`` (MLA or GQA attention), ``rglru``, ``ssd`` and the
encoder-decoder's ``xdec`` (whisper: a stack of non-causal encoder layers
over stub frame embeddings, cross attention over its output), with the
learned position tables of ``rope_theta == 0`` and the ``image_patches``
frontend (pixtral: stub patch embeddings replace the first token
embeddings).

Under autograd each stacked leaf is unbound once per forward, so its
gradient is stacked once (an integer index per layer would write a
zero tensor the size of the whole stack per layer); under a mesh each
layer's gradients are reduced to their shards as the backward makes
them (``_placed``), and ``remat``
checkpoints each stacked group as the reference's ``jax.checkpoint`` of
its scan body: ``"full"`` keeps only the group's input, ``"dots"`` also
keeps the plain products (``aten.mm`` / ``addmm``), the counterpart of
``dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (copy_row, in_context,
                                              reduced_grad, replicate_plain,
                                              shard)
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.layers import Maker, Params

REMATS = ("none", "full", "dots")


# --------------------------------------------------------------------------
# layer kinds
# --------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> List[str]:
    kinds = cfg.layer_kinds()
    if cfg.moe is not None:
        for i in range(min(cfg.moe.first_dense_layers, len(kinds))):
            kinds[i] = "dense_moe"
    if cfg.encoder is not None:
        kinds = ["xdec"] * cfg.num_layers
    return kinds


def _init_layer(cfg: ModelConfig, kind: str, mk: Maker) -> Params:
    if kind == "attn":
        return {"attn": L.init_attention(cfg, mk), "mlp": L.init_mlp(cfg, mk)}
    if kind == "dense_moe":
        att = (mla_mod.init_mla(cfg, mk) if cfg.mla is not None
               else L.init_attention(cfg, mk))
        return {"attn": att,
                "mlp": L.init_mlp(cfg, mk, ff=cfg.moe.dense_ff or cfg.d_ff)}
    if kind == "moe":
        att = (mla_mod.init_mla(cfg, mk) if cfg.mla is not None
               else L.init_attention(cfg, mk))
        return {"attn": att, "moe": moe_mod.init_moe(cfg, mk)}
    if kind == "rglru":
        return {"rec": rec_mod.init_rglru(cfg, mk),
                "mlp": L.init_mlp(cfg, mk)}
    if kind == "ssd":
        return {"ssd": rec_mod.init_ssd(cfg, mk)}
    if kind == "xdec":
        return {"attn": L.init_attention(cfg, mk),
                "cross": L.init_cross_attention(cfg, mk),
                "mlp": L.init_mlp(cfg, mk)}
    raise ValueError(f"unknown layer kind {kind!r}")


def _apply_layer(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, window, cache, kv_len,
                 backend: str, enc_kv=None):
    """One layer: (x, aux loss).  Its cache (if any) is updated in place.
    ``enc_kv``: for ``xdec`` on a call that ran the encoder, a callable
    building the cross keys and values from its output (they are also
    written into the cache); without it they are read from the cache."""
    aux = 0.0
    if kind in ("attn", "dense_moe", "moe", "xdec"):
        c = cache["attn"] if cache else None
        if cfg.mla is not None and kind in ("moe", "dense_moe"):
            x, _ = mla_mod.apply_mla(p["attn"], x, cfg, positions, cache=c,
                                     kv_len=kv_len)
        else:
            x, _ = L.apply_attention(p["attn"], x, cfg, positions,
                                     window=window, cache=c, kv_len=kv_len,
                                     backend=backend)
        if kind == "xdec":
            if enc_kv is not None:           # the encoder ran this call
                ekv = enc_kv(p["cross"])
                if cache:
                    cache["xk"].copy_(ekv[0])
                    cache["xv"].copy_(ekv[1])
            else:                            # decode: the cached cross K/V
                ekv = (cache["xk"], cache["xv"])
            x = L.apply_cross_attention(p["cross"], x, cfg, ekv)
        if kind == "moe":
            return moe_mod.apply_moe(p["moe"], x, cfg)
        return L.apply_mlp(p["mlp"], x, cfg), aux
    if kind == "rglru":
        x, _ = rec_mod.apply_rglru(p["rec"], x, cfg,
                                   cache["rec"] if cache else None)
        return L.apply_mlp(p["mlp"], x, cfg), aux
    if kind == "ssd":
        x, _ = rec_mod.apply_ssd(p["ssd"], x, cfg,
                                 cache["ssd"] if cache else None)
        return x, aux
    raise ValueError(kind)


def _layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype: torch.dtype) -> Dict[str, Any]:
    """{block: {leaf: (shape, dtype)}} of one layer's cache, the
    reference's ``_layer_cache_spec``."""
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    if kind in ("attn", "xdec") or (kind in ("moe", "dense_moe")
                                    and cfg.mla is None):
        kv = ((batch, max_len, KV, hd), dtype)
        spec = {"attn": {"k": kv, "v": kv}}
        if kind == "xdec":
            x = ((batch, cfg.encoder.context, cfg.num_heads, hd), dtype)
            spec["xk"], spec["xv"] = x, x
        return spec
    if kind in ("moe", "dense_moe"):         # MLA compressed cache
        a = cfg.mla
        return {"attn": {"ckv": ((batch, max_len, a.kv_lora), dtype),
                         "kr": ((batch, max_len, a.qk_rope_dim), dtype)}}
    if kind == "rglru":
        return {"rec": rec_mod.rglru_cache_spec(cfg, batch, dtype)}
    if kind == "ssd":
        return {"ssd": rec_mod.ssd_cache_spec(cfg, batch, dtype)}
    raise ValueError(kind)


# --------------------------------------------------------------------------
# layer grouping: stacked pattern groups
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackPlan:
    prefix: Tuple[int, ...]          # layer indices run before the groups
    pattern: Tuple[str, ...]         # kinds of one stacked group
    groups: int                      # number of stacked groups
    suffix: Tuple[int, ...]          # layer indices run after


def stack_plan(cfg: ModelConfig) -> StackPlan:
    kinds = layer_kinds(cfg)
    n = len(kinds)
    # prefix = leading layers not matching the cyclic pattern of the rest
    start = 0
    if cfg.moe is not None:
        start = min(cfg.moe.first_dense_layers, n)
    period_kinds = tuple(kinds[start:start + _period(cfg)])
    period = len(period_kinds)
    groups = (n - start) // period if period else 0
    used = start + groups * period
    return StackPlan(prefix=tuple(range(start)), pattern=period_kinds,
                     groups=groups, suffix=tuple(range(used, n)))


def _period(cfg: ModelConfig) -> int:
    if cfg.encoder is not None:
        return 1
    return len(cfg.pattern)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, mode: str = "shape",
                generator: Optional[torch.Generator] = None,
                device: Any = "cuda",
                dtype: torch.dtype = torch.float32,
                max_seq: int = 0, mesh: Any = None) -> Params:
    """mode: "init" (tensors on ``device``, drawn from ``generator``) |
    "shape" (meta tensors) | "axes" (logical-axes strings, a ``"- "``
    entry for a stacked layer axis), every param in ``dtype``.  With a
    ``mesh``, "init" makes each param a DTensor placed by its axes, with
    the values of the unsharded init (``Maker``).  A learned position
    table (``rope_theta == 0``) has max(max_seq, 2048) rows.  The random
    streams differ from the reference's; ``repro_torch.convert`` carries
    its params over instead."""
    if mode not in ("init", "shape", "axes"):
        raise ValueError(mode)
    plan = stack_plan(cfg)
    kinds = layer_kinds(cfg)

    def mk(lead=()):
        return Maker(mode, generator, device, tuple(lead), dtype, mesh)

    p: Params = {"embed": mk()((cfg.padded_vocab, cfg.d_model), "vocab fsdp")}
    if not cfg.rope_theta:
        p["pos_embed"] = mk()((max(max_seq, 2048), cfg.d_model), "- fsdp")
    # prefix / suffix layers, unrolled, keyed by layer index
    for name, idxs in (("prefix", plan.prefix), ("suffix", plan.suffix)):
        if idxs:
            p[name] = {str(i): _init_layer(cfg, kinds[i], mk())
                       for i in idxs}
    if plan.groups:
        p["scan"] = {f"pos{pos}": _init_layer(cfg, kind, mk((plan.groups,)))
                     for pos, kind in enumerate(plan.pattern)}
    p["final_norm"] = mk()((cfg.d_model,), "embed", init="zeros")
    if not cfg.tie_embeddings:
        p["lm_head"] = mk()((cfg.d_model, cfg.padded_vocab), "fsdp vocab")
    if cfg.encoder is not None:
        e = cfg.encoder
        ecfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "pos_embed": mk()((e.context, ecfg.d_model), "- fsdp"),
            "scan": _init_layer(ecfg, "attn", mk((e.num_layers,))),
            "final_norm": mk()((ecfg.d_model,), "embed", init="zeros")}
    return p


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: its own width and depth, plain
    non-causal attention layers, learned positions."""
    e = cfg.encoder
    return dataclasses.replace(
        cfg, d_model=e.d_model or cfg.d_model, num_layers=e.num_layers,
        pattern=("attn",), rope_theta=0.0, moe=None, mla=None, encoder=None)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _cast(tree, dtype: torch.dtype):
    """A tree with its leaves in ``dtype`` (the same tensors where they
    already are)."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked param or cache tree, each leaf unbound
    once along its layer axis (views of the same storage): under autograd
    each layer's gradient then lands in one stacked gradient
    (``UnbindBackward``), where an index per layer would write a zero
    tensor the size of the stack for each layer."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _groups(cfg: ModelConfig, plan: StackPlan, params: Params,
            cache: Optional[Params]):
    """The stacked groups in order, each a list of (kind, params, cache,
    window) of its layers; a global layer gets window None, which lets
    decode take the kernel (the reference's scan carries a 1<<30 sentinel
    there, so its pallas decode path is never reached in a stack)."""
    windows = cfg.layer_windows()
    start, period = len(plan.prefix), len(plan.pattern)
    per = [_unstack(params["scan"][f"pos{pos}"], plan.groups)
           for pos in range(period)]
    cper = [_unstack(cache["scan"][f"pos{pos}"], plan.groups)
            if cache is not None else [None] * plan.groups
            for pos in range(period)]
    for g in range(plan.groups):
        yield [(kind, _placed(per[pos][g]), cper[pos][g],
                windows[start + g * period + pos])
               for pos, kind in enumerate(plan.pattern)]


def _placed(tree):
    """A layer's param tree whose gradients are placed as the params are
    as soon as the backward makes them (``sharding.reduced_grad``): under
    a mesh a data-sharded weight's gradient comes back ``Partial``,
    whole-size on every rank, and is reduced to its shard there, the
    reduce-scatter GSPMD inserts in the reference's backward, rather than
    at the stack or the end.  Made just before the layer runs, so the
    backward reaches each layer's reduction before the layer below (the
    autograd engine runs the later-made of two ready nodes first)."""
    return {k: _placed(v) if isinstance(v, dict) else reduced_grad(v)
            for k, v in tree.items()}


# the products "dots" remat keeps: plain 2-D ones, as the reference's
# dots_with_no_batch_dims_saveable (a batched product is recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (stub frontend).
    It runs in the frames' and params' promoted dtype, as the reference's
    products promote: f32 frames take bf16 params' encoder in f32."""
    ecfg = _encoder_cfg(cfg)
    enc = params["encoder"]
    dt = torch.promote_types(frames.dtype, enc["pos_embed"].dtype)
    enc = _cast(enc, dt)
    x = frames.to(dt) + enc["pos_embed"][None, :frames.shape[1]]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in _unstack(enc["scan"], ecfg.num_layers):
        h, _ = L.apply_attention(p["attn"], x, ecfg, positions, window=None,
                                 causal=False)
        x = L.apply_mlp(p["mlp"], h, ecfg)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None, backend: str = "cuda",
            remat: str = "none"
            ) -> Tuple[torch.Tensor, Optional[Params],
                       Union[float, torch.Tensor]]:
    """tokens: (B, S) -> (logits (B, S, V), cache, aux loss).

    cache=None: training forward.  cache given: prefill (S>1, fresh cache)
    or decode (S==1); the cache is updated in place (new keys and values,
    latents, recurrent states and cross keys and values written into its
    own tensors, ``len`` advanced) and the same dict is returned.  ``len``
    is an int, the length of every row; or a (B,) numpy array of per-row
    lengths (the continuous engine's slots), which the host checks
    against the cache's depth and uploads once for every layer of the
    step; or a (B,) int32 tensor on the tokens' device, which is read
    where it lies (a captured step's lengths buffer,
    ``serve.graphs.DecodeGraph``; its caller checks the depth).  Both
    per-row forms write each row at its own positions.

    ``extra_embeds``: patch embeddings (pixtral: they replace the first
    min(P, S) token embeddings) or frame embeddings (whisper: the encoder
    runs on them, and its cross keys and values go into the cache).
    ``remat`` ("none" | "full" | "dots") checkpoints each stacked group of
    a training forward (no cache, grad enabled).  The aux loss is the sum
    of the MoE layers' load-balancing losses, a 0-d f32 tensor; 0.0 (a
    float) for a model without an MoE layer, so that its steps gain no
    kernels (``Model.loss`` makes it a tensor).  With DTensor params (a
    mesh), plain tensors that meet them count as replicated
    (``sharding.replicate_plain``).
    """
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} not in {REMATS}")
    with replicate_plain(params["final_norm"]):
        return _forward(params, cfg, tokens, extra_embeds, cache, backend,
                        remat)


def _forward(params, cfg, tokens, extra_embeds, cache, backend, remat):
    plan = stack_plan(cfg)
    kinds = layer_kinds(cfg)
    B, S = tokens.shape
    kv_len = cache["len"] if cache is not None else None

    x = L.embed(params["embed"], tokens.long())
    x = x * _embed_scale(cfg.d_model, x.dtype, x.device)
    if cfg.frontend == "image_patches" and extra_embeds is not None:
        n = min(extra_embeds.shape[1], S)
        x = torch.cat([extra_embeds[:, :n].to(x.dtype), x[:, n:]], dim=1)
    steps = torch.arange(S, device=x.device)
    if isinstance(kv_len, np.ndarray):
        smax = depth(cache)
        if smax is not None and int(kv_len.max()) + S > smax:
            raise ValueError(f"KV cache full: {int(kv_len.max())} + {S} > "
                             f"{smax}")
        lens = torch.as_tensor(kv_len, device=x.device).to(torch.int32)
        positions = lens[:, None] + steps
    elif torch.is_tensor(kv_len):
        if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
            raise TypeError(f"len: a ({B},) int32 tensor, not "
                            f"{tuple(kv_len.shape)} {kv_len.dtype}")
        lens = kv_len
        positions = lens[:, None] + steps
    else:
        lens = kv_len
        start = kv_len if kv_len is not None else 0
        positions = (start + steps)[None, :].expand(B, S)
    if not cfg.rope_theta:
        tab = params["pos_embed"]
        x = x + L.embed(tab, torch.clamp(positions, max=tab.shape[0] - 1)
                        ).to(x.dtype)
    x = shard(x, "batch", None, None)

    enc_kv = None
    if cfg.encoder is not None and extra_embeds is not None:
        enc_out = encode(params, cfg, extra_embeds)
        enc_kv = lambda pc: L.cross_kv(pc, cfg, enc_out)   # noqa: E731

    def run(layers, x):
        aux = 0.0
        for kind, p, c, window in layers:
            x, a = _apply_layer(kind, p, x, cfg, positions, window, c, lens,
                                backend, enc_kv)
            aux = aux + a
        return x, aux

    windows = cfg.layer_windows()

    def unrolled(name, idxs):
        return [(kinds[i], _placed(params[name][str(i)]),
                 cache[name][str(i)] if cache is not None else None,
                 windows[i]) for i in idxs]

    x, aux = run(unrolled("prefix", plan.prefix), x)
    checkpointed = (remat != "none" and cache is None
                    and torch.is_grad_enabled())
    for layers in _groups(cfg, plan, params, cache):
        if checkpointed:
            kw = {"context_fn": _dots_context} if remat == "dots" else {}
            # recomputed in the backward, on the autograd engine's device
            # thread for CUDA tensors: under this thread's mesh
            x, a = ckpt.checkpoint(in_context(functools.partial(run, layers)),
                                   x, use_reentrant=False, **kw)
        else:
            x, a = run(layers, x)
        aux = aux + a
    x, a = run(unrolled("suffix", plan.suffix), x)
    aux = aux + a

    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ reduced_grad(params["embed"]).T
    else:
        logits = x @ reduced_grad(params["lm_head"])
    logits = shard(logits, "batch", None, "vocab")
    if cache is not None:
        cache["len"] = kv_len + S
        if cfg.encoder is not None:
            cache["enc_done"] = 1
    return logits, cache, aux


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """sqrt(d_model) as a 0-d tensor of ``dtype`` on ``device``, made once:
    an upload from the host cannot be captured in a CUDA graph."""
    return torch.tensor(math.sqrt(d_model), dtype=torch.float32,
                        device=device).to(dtype)


# --------------------------------------------------------------------------
# cache trees
# --------------------------------------------------------------------------

# the cache leaves with a sequence axis (the positions a row can hold)
_SEQ_LEAVES = ("k", "v", "ckv", "kr")
# a cache's top-level counters (host ints), not tensors: the cached
# positions, and for an encoder-decoder whether the encoder has run
_SCALARS = ("len", "enc_done")


def cache_items(cache: Params):
    """(leaf name, tensor, batch axis) of every tensor of a cache tree, in
    the tree's order (which ``cache_spec`` fixes): the batch axis is 1 for
    a leaf stacked on the group axis (under ``scan``), 0 for one of the
    unrolled ``prefix`` / ``suffix`` layers."""
    def walk(tree, axis):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, 1 if k == "scan" else axis)
            elif k not in _SCALARS:
                yield k, v, axis
    yield from walk(cache, 0)


def cache_leaves(cache: Params):
    """The tensors of a cache tree, in the tree's order."""
    for _, leaf, _ in cache_items(cache):
        yield leaf


def depth(cache: Params) -> Optional[int]:
    """The positions a row of ``cache`` can hold: the sequence axis of its
    attention keys or MLA latents, or None for a cache with no such leaf
    (an attention-free model, which holds constant-size states; its
    engines bound a row by their own ``max_len``)."""
    for name, leaf, axis in cache_items(cache):
        if name in _SEQ_LEAVES:
            return leaf.shape[axis + 1]
    return None


def reset(cache: Params) -> Params:
    """Empty ``cache`` in place for a new prefill: ``len`` 0 and every
    leaf without a sequence axis (recurrent states, conv windows) zeroed,
    as a fresh cache holds them.  Keys, values and latents are left: the
    positions past a row's length get no weight."""
    for name, leaf, _ in cache_items(cache):
        if name not in _SEQ_LEAVES:
            leaf.zero_()
    cache["len"] = 0
    if "enc_done" in cache:
        cache["enc_done"] = 0
    return cache


def copy_rows(dst: Params, d: int, src: Params, s: int) -> None:
    """Copy row ``s`` of every leaf of cache ``src`` into row ``d`` of the
    same leaf of ``dst`` (trees of one model; each leaf on its own batch
    axis, ``cache_leaves``); ``len`` is left to the caller.  On a mesh
    each rank copies only its own piece (``sharding.copy_row``)."""
    for (_, big, axis), (_, one, _) in zip(cache_items(dst),
                                           cache_items(src)):
        copy_row(big, axis, d, one, s)


# logical axes of each cache leaf, the reference's
_CACHE_AXES = {"k": "batch kv_seq kv_heads -", "v": "batch kv_seq kv_heads -",
               "ckv": "batch kv_seq -", "kr": "batch kv_seq -",
               "xk": "batch - heads -", "xv": "batch - heads -",
               "h": "batch ff", "conv": "batch - ff",
               "state": "batch heads - -"}


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               mode: str = "shape", device: Any = "cuda",
               dtype: torch.dtype = torch.float32) -> Params:
    """Cache tree as meta tensors ("shape"), zeros on ``device`` ("init")
    or logical-axes strings ("axes": the reference's per leaf, a ``"- "``
    entry for the group axis under ``scan``, ``""`` for ``len`` and
    ``enc_done``), laid out as the reference's: per layer the leaves of its
    kind (``_layer_cache_spec``; attention keys and values and MLA latents
    in ``dtype``, recurrent states in f32, conv windows in ``dtype``),
    the stacked groups' leaves with a leading group axis under ``scan``,
    the unrolled layers' under ``prefix`` / ``suffix`` keyed by layer
    index.  ``len``, the count of cached positions, is a Python int in
    "init" mode (the host always knows it, so reading it never waits for
    the device) and a 0-d int32 meta tensor in "shape" mode; so is an
    encoder-decoder's ``enc_done``."""
    if mode not in ("shape", "init", "axes"):
        raise ValueError(mode)
    plan = stack_plan(cfg)
    kinds = layer_kinds(cfg)

    def build(spec, lead=()):
        out = {}
        for k, v in spec.items():
            if isinstance(v, dict):
                out[k] = build(v, lead)
            elif mode == "axes":
                out[k] = "- " * len(lead) + _CACHE_AXES[k]
            else:
                shape, dt = lead + v[0], v[1]
                out[k] = (torch.empty(shape, dtype=dt, device="meta")
                          if mode == "shape" else
                          torch.zeros(shape, dtype=dt, device=device))
        return out

    out: Dict[str, Any] = {}
    for name, idxs in (("prefix", plan.prefix), ("suffix", plan.suffix)):
        if idxs:
            out[name] = {str(i): build(_layer_cache_spec(
                cfg, kinds[i], batch, max_len, dtype)) for i in idxs}
    if plan.groups:
        out["scan"] = {f"pos{pos}": build(_layer_cache_spec(
            cfg, kind, batch, max_len, dtype), (plan.groups,))
            for pos, kind in enumerate(plan.pattern)}
    for name in _SCALARS if cfg.encoder is not None else _SCALARS[:1]:
        out[name] = {"shape": torch.empty((), dtype=torch.int32,
                                          device="meta"),
                     "init": 0, "axes": ""}[mode]
    return out
