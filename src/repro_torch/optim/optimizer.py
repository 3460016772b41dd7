"""Optimizers: AdamW and a factored variant, and SGD.

The PyTorch counterpart of ``repro/optim/optimizer.py``: the same
arithmetic, in f32.  ``factored=True`` replaces the full second moment of
every parameter whose last two axes are at least 8 with row / column
statistics (Adafactor-style).

Where the reference returns new trees, ``update`` writes the new params
and moments into the tensors it was given, under ``torch.no_grad()``, and
returns those same tensors: a step holds one copy of each, as the
in-place KV cache does in serving.  Param trees are nested dicts of
tensors; their leaves are visited in sorted key order, the order of
``jax.tree.leaves``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Params = Any


class OptState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    m: Params
    v: Params                 # full v, or {"row": ..., "col": ...} if factored


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params],
                     Tuple[Params, OptState, Dict[str, torch.Tensor]]]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts (sorted key order) and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, ``rest`` following
    ``tree``'s keys (a factored second moment's {"row", "col"} dict is
    passed to ``fn`` whole, beside its param)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to a global norm of at most ``max_norm``, its
    norm); the leaves are scaled in place."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    with torch.no_grad():
        for x in tree_leaves(tree):
            x.mul_(scale.to(x.dtype))
    return tree, norm


def _is_factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _is_v_leaf(x) -> bool:
    return isinstance(x, dict) and ("full" in x or "row" in x)


def _zeros(shape, dtype, like: torch.Tensor, drop: Optional[int] = None
           ) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; for a DTensor ``like``, a
    DTensor on its mesh with its placements, where ``shape`` is ``like``'s
    with axis ``drop`` (-1 or -2) removed (a factored moment)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, zeros
    if not isinstance(like, DTensor):
        return torch.zeros(tuple(shape), dtype=dtype, device=like.device)
    nd = like.ndim
    gone = None if drop is None else nd + drop

    def moved(pl):
        if not isinstance(pl, Shard) or gone is None:
            return pl
        if pl.dim == gone:
            return Replicate()
        return Shard(pl.dim - 1) if pl.dim > gone else pl
    return zeros(tuple(shape), dtype=dtype, device_mesh=like.device_mesh,
                 placements=[moved(pl) for pl in like.placements])


def adamw(lr_fn: Callable[[torch.Tensor], torch.Tensor], *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0, factored: bool = False,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:

    def init(params: Params) -> OptState:
        m = tree_map(lambda p: _zeros(p.shape, state_dtype, p), params)
        if factored:
            def vinit(p):
                if _is_factorable(p.shape):
                    return {"row": _zeros(p.shape[:-1], state_dtype, p, -1),
                            "col": _zeros(p.shape[:-2] + p.shape[-1:],
                                          state_dtype, p, -2)}
                return {"full": _zeros(p.shape, state_dtype, p)}
            v = tree_map(vinit, params)
        else:
            v = tree_map(lambda p: _zeros(p.shape, state_dtype, p), params)
        first = tree_leaves(params)[0]
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=first.device), m=m, v=v)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        metrics: Dict[str, torch.Tensor] = {}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        lr = lr_fn(step)
        metrics["lr"] = lr
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def mupd(m, g):
            m.copy_(b1 * m + (1 - b1) * g.to(state_dtype))

        def vupd(v, g):
            if _is_v_leaf(v):
                g2 = torch.square(g.float())
                if "full" in v:
                    v["full"].copy_(b2 * v["full"] + (1 - b2) *
                                    g2.to(state_dtype))
                    return v["full"].float() / bc2
                v["row"].copy_(b2 * v["row"] + (1 - b2) *
                               g2.mean(-1).to(state_dtype))
                v["col"].copy_(b2 * v["col"] + (1 - b2) *
                               g2.mean(-2).to(state_dtype))
                row = v["row"].float() / bc2
                col = v["col"].float() / bc2
                denom = torch.clamp(row.mean(-1, keepdim=True), min=1e-30)
                return row[..., None] * col[..., None, :] / denom[..., None]
            v.copy_(b2 * v + (1 - b2) * torch.square(g.to(state_dtype)))
            return v.float() / bc2

        def pupd(p, m, v, g):
            mupd(m, g)
            vh = vupd(v, g)
            mhat = m.float() / bc1
            upd = mhat / (torch.sqrt(vh) + eps)
            upd = upd + weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))

        # leaf by leaf, so a step's temporaries are one leaf's
        tree_map(pupd, params, state.m, state.v, grads)
        state.step.copy_(step)
        return params, state, metrics

    return Optimizer(init=init, update=update)


def sgd(lr_fn, momentum: float = 0.9) -> Optimizer:
    def init(params):
        first = tree_leaves(params)[0]
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=first.device),
                        m=tree_map(torch.zeros_like, params), v=())

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr = lr_fn(step)

        def pupd(p, m, g):
            m.copy_(momentum * m + g)
            p.copy_(p - lr * m)

        tree_map(pupd, params, state.m, grads)
        state.step.copy_(step)
        return params, state, {"lr": lr}

    return Optimizer(init=init, update=update)
