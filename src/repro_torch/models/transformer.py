"""Architecture-generic transformer stack, layer kind ``attn``.

The PyTorch counterpart of ``repro/models/transformer.py``.  Layers are
grouped by the config's cyclic ``pattern`` exactly as in the reference, so
the param and cache trees have the same keys and layouts: the repeated
groups are stacked along a leading layer axis under ``params["scan"]``.
Where the reference runs ``lax.scan`` over that axis, the port runs a
Python loop that indexes it.

Only layer kind ``attn`` is ported; the others raise NotImplementedError
naming the kind.
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
from repro_torch.models.layers import Maker, Params

PORTED_KINDS = ("attn",)


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


def _init_layer(cfg: ModelConfig, mk: Maker) -> Params:
    return {"attn": L.init_attention(cfg, mk), "mlp": L.init_mlp(cfg, mk)}


def _apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, window, cache, kv_len,
                 backend: str) -> torch.Tensor:
    x, _ = L.apply_attention(p["attn"], x, cfg, positions, window=window,
                             cache=cache["attn"] if cache else None,
                             kv_len=kv_len, backend=backend)
    return L.apply_mlp(p["mlp"], x, cfg)


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
    lacks.  With every layer of kind ``attn`` there is no unrolled prefix
    or suffix: all layers sit in the stacked groups."""
    for kind in layer_kinds(cfg):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported to PyTorch "
                f"yet (ported: {PORTED_KINDS})")
    plan = stack_plan(cfg)
    if plan.prefix or plan.suffix:
        raise NotImplementedError(
            f"{cfg.name}: unrolled prefix/suffix layers are not ported yet")
    if cfg.frontend is not None or not cfg.rope_theta:
        raise NotImplementedError(
            f"{cfg.name}: frontends and learned position tables are not "
            "ported to PyTorch yet")
    return plan


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

    def mk(lead=()):
        return Maker(mode, generator, device, tuple(lead), dtype)

    p: Params = {"embed": mk()((cfg.padded_vocab, cfg.d_model), "vocab fsdp")}
    if plan.groups:
        p["scan"] = {f"pos{pos}": _init_layer(cfg, mk((plan.groups,)))
                     for pos in range(len(plan.pattern))}
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
    """(params, cache, window) of every layer in order: the stacked groups
    indexed along their layer axis (views, no copies)."""
    windows = cfg.layer_windows()
    for g in range(plan.groups):
        for pos in range(len(plan.pattern)):
            key = f"pos{pos}"
            # a global layer gets window None, which lets decode take the
            # kernel (the reference's scan carries a 1<<30 sentinel there,
            # so its pallas decode path is never reached in a stack)
            yield (_index(params["scan"][key], g),
                   _index(cache["scan"][key], g) if cache is not None
                   else None,
                   windows[g * len(plan.pattern) + pos])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Params] = None,
            backend: str = "cuda") -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens: (B, S) -> (logits (B, S, V), cache).

    cache=None: training forward.  cache given: prefill (S>1, fresh cache)
    or decode (S==1); the cache is updated in place (new keys and values
    written, ``len`` advanced) and the same dict is returned.  ``len`` is
    an int, the length of every row; or a (B,) numpy array of per-row
    lengths (the continuous engine's slots), which the host checks
    against the cache's depth and uploads once for every layer of the
    step; or a (B,) int32 tensor on the tokens' device, which is read
    where it lies (a captured step's lengths buffer,
    ``serve.graphs.DecodeGraph``; its caller checks the depth).  Both
    per-row forms write each row at its own positions.
    """
    plan = _check_supported(cfg)
    B, S = tokens.shape
    kv_len = cache["len"] if cache is not None else None

    x = params["embed"][tokens.long()]
    x = x * _embed_scale(cfg.d_model, x.dtype, x.device)
    steps = torch.arange(S, device=x.device)
    if isinstance(kv_len, np.ndarray):
        smax = _depth(cache)
        if int(kv_len.max()) + S > smax:
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

    for p, c, window in _layers(cfg, plan, params, cache):
        x = _apply_layer(p, x, cfg, positions, window, c, lens, backend)

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


def _depth(cache: Params) -> int:
    """The cache's depth (positions per row)."""
    return next(cache_leaves(cache)).shape[2]


def cache_leaves(cache: Params):
    """The K and V buffers of a cache tree, in the tree's order (which
    ``cache_spec`` fixes)."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from cache_leaves(v)
        elif k != "len":
            yield v


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               mode: str = "shape", device: Any = "cuda",
               dtype: torch.dtype = torch.float32) -> Params:
    """Cache tree as ``dtype`` meta tensors ("shape") or zeros on
    ``device`` ("init"), each (groups, batch, max_len, KV, hd).  ``len``,
    the count of cached positions, is a Python int in "init" mode (the
    host always knows it, so reading it never waits for the device) and a
    0-d int32 meta tensor in "shape" mode."""
    if mode not in ("shape", "init"):
        raise ValueError(mode)
    plan = _check_supported(cfg)
    shape = (plan.groups, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)

    def leaf():
        if mode == "shape":
            return torch.empty(shape, dtype=dtype, device="meta")
        return torch.zeros(shape, dtype=dtype, device=device)

    out: Dict[str, Any] = {}
    if plan.groups:
        out["scan"] = {f"pos{pos}": {"attn": {"k": leaf(), "v": leaf()}}
                       for pos in range(len(plan.pattern))}
    out["len"] = (torch.empty((), dtype=torch.int32, device="meta")
                  if mode == "shape" else 0)
    return out
