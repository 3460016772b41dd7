"""Architecture-generic transformer stack.

The PyTorch counterpart of ``repro/models/transformer.py``.  Layers are
grouped by the config's cyclic ``pattern`` exactly as in the reference, so
the param and cache trees have the same keys and layouts: the repeated
groups are stacked along a leading layer axis under ``params["scan"]``.
Where the reference runs ``lax.scan`` over that axis, the port runs a
Python loop that indexes it; a non-conforming prefix (deepseek's and
kimi-k2's leading dense layer) or suffix (recurrentgemma's trailing
recurrent pair) is unrolled around the groups under ``prefix`` /
``suffix``, keyed by layer index.

Layer kinds ``attn``, ``dense_moe``, ``moe`` (MLA or GQA attention),
``rglru`` and ``ssd`` are ported; the encoder-decoder's ``xdec``, the
modality frontends and learned position tables raise
NotImplementedError naming what is missing.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.layers import Maker, Params

PORTED_KINDS = ("attn", "dense_moe", "moe", "rglru", "ssd")


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
    raise ValueError(f"unknown layer kind {kind!r}")


def _apply_layer(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, window, cache, kv_len,
                 backend: str) -> torch.Tensor:
    """One layer; its cache (if any) is updated in place.  The MoE
    layer's auxiliary loss is dropped: nothing here trains."""
    if kind in ("attn", "dense_moe", "moe"):
        c = cache["attn"] if cache else None
        if cfg.mla is not None and kind in ("moe", "dense_moe"):
            x, _ = mla_mod.apply_mla(p["attn"], x, cfg, positions, cache=c,
                                     kv_len=kv_len)
        else:
            x, _ = L.apply_attention(p["attn"], x, cfg, positions,
                                     window=window, cache=c, kv_len=kv_len,
                                     backend=backend)
        if kind == "moe":
            x, _ = moe_mod.apply_moe(p["moe"], x, cfg)
            return x
        return L.apply_mlp(p["mlp"], x, cfg)
    if kind == "rglru":
        x, _ = rec_mod.apply_rglru(p["rec"], x, cfg,
                                   cache["rec"] if cache else None)
        return L.apply_mlp(p["mlp"], x, cfg)
    if kind == "ssd":
        x, _ = rec_mod.apply_ssd(p["ssd"], x, cfg,
                                 cache["ssd"] if cache else None)
        return x
    raise ValueError(kind)


def _layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype: torch.dtype) -> Dict[str, Any]:
    """{block: {leaf: (shape, dtype)}} of one layer's cache, the
    reference's ``_layer_cache_spec``."""
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    if kind == "attn" or (kind in ("moe", "dense_moe") and cfg.mla is None):
        kv = ((batch, max_len, KV, hd), dtype)
        return {"attn": {"k": kv, "v": kv}}
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


def _check_supported(cfg: ModelConfig) -> StackPlan:
    """The config's StackPlan, or NotImplementedError naming what the port
    lacks: the encoder-decoder (``xdec``, ROADMAP A8b.4) and the modality
    frontends and learned position tables (A8b.5)."""
    for kind in layer_kinds(cfg):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported to PyTorch "
                f"yet (ported: {PORTED_KINDS}; ROADMAP A8b.4)")
    if cfg.frontend is not None or not cfg.rope_theta:
        raise NotImplementedError(
            f"{cfg.name}: frontends (extra_embeds) and learned position "
            "tables are not ported to PyTorch yet (ROADMAP A8b.5)")
    return stack_plan(cfg)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, mode: str = "shape",
                generator: Optional[torch.Generator] = None,
                device: Any = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """mode: "init" (tensors on ``device``, drawn from ``generator``) |
    "shape" (meta tensors), every param in ``dtype``.  The random streams
    differ from the reference's; ``repro_torch.convert`` carries its
    params over instead."""
    plan = _check_supported(cfg)
    kinds = layer_kinds(cfg)

    def mk(lead=()):
        return Maker(mode, generator, device, tuple(lead), dtype)

    p: Params = {"embed": mk()((cfg.padded_vocab, cfg.d_model), "vocab fsdp")}
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
    return p


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _index(tree, i: int):
    """Layer ``i`` of a stacked param or cache tree."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(cfg: ModelConfig, plan: StackPlan, params: Params,
            cache: Optional[Params]):
    """(kind, params, cache, window) of every layer in order: the prefix,
    the stacked groups indexed along their layer axis (views, no copies),
    the suffix."""
    kinds = layer_kinds(cfg)
    # a global layer gets window None, which lets decode take the kernel
    # (the reference's scan carries a 1<<30 sentinel there, so its pallas
    # decode path is never reached in a stack)
    windows = cfg.layer_windows()

    def unrolled(name, idxs):
        for i in idxs:
            yield (kinds[i], params[name][str(i)],
                   cache[name][str(i)] if cache is not None else None,
                   windows[i])

    yield from unrolled("prefix", plan.prefix)
    start = len(plan.prefix)
    for g in range(plan.groups):
        for pos, kind in enumerate(plan.pattern):
            key = f"pos{pos}"
            yield (kind, _index(params["scan"][key], g),
                   _index(cache["scan"][key], g) if cache is not None
                   else None,
                   windows[start + g * len(plan.pattern) + pos])
    yield from unrolled("suffix", plan.suffix)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Params] = None,
            backend: str = "cuda") -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens: (B, S) -> (logits (B, S, V), cache).

    cache=None: training forward.  cache given: prefill (S>1, fresh cache)
    or decode (S==1); the cache is updated in place (new keys and values,
    latents and recurrent states written into its own tensors, ``len``
    advanced) and the same dict is returned.  ``len`` is an int, the
    length of every row; or a (B,) numpy array of per-row lengths (the
    continuous engine's slots), which the host checks against the cache's
    depth and uploads once for every layer of the step; or a (B,) int32
    tensor on the tokens' device, which is read where it lies (a captured
    step's lengths buffer, ``serve.graphs.DecodeGraph``; its caller checks
    the depth).  Both per-row forms write each row at its own positions.
    """
    plan = _check_supported(cfg)
    B, S = tokens.shape
    kv_len = cache["len"] if cache is not None else None

    x = params["embed"][tokens.long()]
    x = x * _embed_scale(cfg.d_model, x.dtype, x.device)
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

    for kind, p, c, window in _layers(cfg, plan, params, cache):
        x = _apply_layer(kind, p, x, cfg, positions, window, c, lens, backend)

    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    if cache is not None:
        cache["len"] = kv_len + S
    return logits, cache


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


def cache_items(cache: Params):
    """(leaf name, tensor, batch axis) of every tensor of a cache tree, in
    the tree's order (which ``cache_spec`` fixes): the batch axis is 1 for
    a leaf stacked on the group axis (under ``scan``), 0 for one of the
    unrolled ``prefix`` / ``suffix`` layers."""
    def walk(tree, axis):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, 1 if k == "scan" else axis)
            elif k != "len":
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
    return cache


def copy_rows(dst: Params, d: int, src: Params, s: int) -> None:
    """Copy row ``s`` of every leaf of cache ``src`` into row ``d`` of the
    same leaf of ``dst`` (trees of one model; each leaf on its own batch
    axis, ``cache_leaves``); ``len`` is left to the caller."""
    for (_, big, axis), (_, one, _) in zip(cache_items(dst),
                                           cache_items(src)):
        big.select(axis, d).copy_(one.select(axis, s))


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               mode: str = "shape", device: Any = "cuda",
               dtype: torch.dtype = torch.float32) -> Params:
    """Cache tree as meta tensors ("shape") or zeros on ``device``
    ("init"), laid out as the reference's: per layer the leaves of its
    kind (``_layer_cache_spec``; attention keys and values and MLA latents
    in ``dtype``, recurrent states in f32, conv windows in ``dtype``),
    the stacked groups' leaves with a leading group axis under ``scan``,
    the unrolled layers' under ``prefix`` / ``suffix`` keyed by layer
    index.  ``len``, the count of cached positions, is a Python int in
    "init" mode (the host always knows it, so reading it never waits for
    the device) and a 0-d int32 meta tensor in "shape" mode."""
    if mode not in ("shape", "init"):
        raise ValueError(mode)
    plan = _check_supported(cfg)
    kinds = layer_kinds(cfg)

    def build(spec, lead=()):
        out = {}
        for k, v in spec.items():
            if isinstance(v, dict):
                out[k] = build(v, lead)
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
    out["len"] = (torch.empty((), dtype=torch.int32, device="meta")
                  if mode == "shape" else 0)
    return out
