"""Train-step factory: gradient accumulation over microbatches, remat.

The PyTorch counterpart of ``repro/train/step.py``.  ``make_train_step``
builds the (state, batch) -> (state, metrics) function the trainer and
the launcher run: the loss and its gradients through autograd
(``torch.autograd.grad`` over every param leaf), summed over
``microbatches`` slices of the batch and averaged, then one optimizer
update, which writes the new params and moments in place
(``optim.optimizer``).  ``RunConfig.remat`` checkpoints the stacked
groups of the forward (``models.transformer.forward``).

Under a mesh the params and moments are DTensors
(``init_state_sharded``); the step is the same code, with each gradient
redistributed to its param's placements before the in-place update (the
layers' weights and the head's are placed already: the forward reduces
each as the backward makes it, ``transformer._placed``).
``TrainConfig.grad_compress`` is accepted and not read, as in the
reference.

``TrainState.rng`` is a (2,) uint32 tensor on the host: a seed word and
a counter that each step advances.  Nothing draws from it; the
reference's ``fold_in`` stream cannot be reproduced in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import (full, is_dtensor,
                                              map_shardings, replicate_plain,
                                              shard, tree_shardings)
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import (Optimizer, OptState, tree_leaves,
                                         tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    rng: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_compress: bool = False       # int8 error-feedback DP reduction


def new_rng(seed: int, count: int = 1) -> torch.Tensor:
    """A state's rng: ``seed`` (its low 32 bits) and the counter."""
    return torch.tensor([seed & 0xFFFFFFFF, count & 0xFFFFFFFF],
                        dtype=torch.uint32)


def next_rng(rng: torch.Tensor) -> torch.Tensor:
    """The state's rng one step on: the counter advanced by one."""
    seed, count = (int(x) for x in rng.tolist())
    return new_rng(seed, count + 1)


def init_state(model: Model, optimizer: Optimizer,
               generator: torch.Generator) -> TrainState:
    """Params drawn from ``generator`` (on the model's device), fresh
    optimizer state, and the rng (the generator's seed, counter 1)."""
    params = model.init(generator)
    return TrainState(params=params, opt=optimizer.init(params),
                      rng=new_rng(generator.initial_seed(), 1))


def state_shapes(model: Model, optimizer: Optimizer) -> TrainState:
    """The TrainState as meta tensors (shapes and dtypes, nothing
    allocated)."""
    pshapes = model.param_shapes()
    return TrainState(params=pshapes, opt=optimizer.init(pshapes),
                      rng=torch.empty((2,), dtype=torch.uint32,
                                      device="meta"))


def state_axes(model: Model, optimizer: Optimizer) -> TrainState:
    """Logical-axes TrainState matching ``state_shapes`` structure.

    Optimizer ``m`` mirrors the params tree (same axes).  A factored ``v``
    stores {"row","col"} (or {"full"}) per param; row drops the last
    logical axis, col drops the second-to-last.
    """
    paxes = model.param_axes()
    opt_shapes = optimizer.init(model.param_shapes())

    def v_leaf_axes(p_ax: str, v_leaf) -> Any:
        ax = p_ax.split()
        if isinstance(v_leaf, dict):
            out = {}
            if "full" in v_leaf:
                out["full"] = p_ax
            if "row" in v_leaf:
                out["row"] = " ".join(ax[:-1]) or "-"
            if "col" in v_leaf:
                out["col"] = " ".join(ax[:-2] + ax[-1:]) or "-"
            return out
        return p_ax

    def walk(p_ax, v_sub):
        if isinstance(v_sub, dict) and ("full" in v_sub or "row" in v_sub):
            return v_leaf_axes(p_ax, v_sub)
        if isinstance(v_sub, dict):
            return {k: walk(p_ax[k], v_sub[k]) for k in v_sub}
        return p_ax

    v_shapes = opt_shapes.v
    v_axes = () if isinstance(v_shapes, tuple) and v_shapes == () \
        else walk(paxes, v_shapes)
    return TrainState(params=paxes,
                      opt=OptState(step="", m=paxes, v=v_axes),
                      rng="-")


def state_shardings(model: Model, optimizer: Optimizer, mesh) -> TrainState:
    """The ``Sharding`` of every leaf of a TrainState on ``mesh``
    (``tree_shardings`` of ``state_axes``); the optimizer's step counter
    (0-d, replicated) and the host rng get None: they stay plain
    tensors."""
    sh = tree_shardings(state_axes(model, optimizer),
                        state_shapes(model, optimizer), mesh)
    return TrainState(sh.params, sh.opt._replace(step=None), None)


def init_state_sharded(model: Model, optimizer: Optimizer,
                       generator: torch.Generator, mesh) -> TrainState:
    """``init_state`` as DTensors on ``mesh``, with the same values: each
    param drawn whole in the unsharded init's order and cut to its piece
    (``Model.init(mesh=)``), each moment made as zeros of its piece
    (``state_shardings``); no rank holds a second whole copy."""
    from torch.distributed.tensor import zeros
    sh = state_shardings(model, optimizer, mesh)
    params = model.init(generator, mesh=mesh)
    shapes = state_shapes(model, optimizer)

    def zero(s, t):
        return zeros(tuple(t.shape), dtype=t.dtype, device_mesh=s.mesh,
                     placements=s.placements)
    opt = OptState(
        step=torch.zeros((), dtype=torch.int32, device=model.device),
        m=map_shardings(zero, sh.opt.m, shapes.opt.m),
        v=map_shardings(zero, sh.opt.v, shapes.opt.v))
    return TrainState(params=params, opt=opt,
                      rng=new_rng(generator.initial_seed(), 1))


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def make_train_step(model: Model, optimizer: Optimizer,
                    tcfg: TrainConfig = TrainConfig()
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                            Dict]]:
    # ``tcfg.grad_compress`` is accepted and, as in the reference's
    # make_train_step, not read
    loss_fn = make_loss_fn(model)

    def single(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad(), replicate_plain(leaves[0]):
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(shard(loss), leaves)
            # under a mesh a gradient comes back with the placements
            # autograd gives it (a data-sharded weight's is Partial over
            # data) unless the forward placed it already: redistributing
            # it to its param's placements is the data-parallel reduction
            # GSPMD inserts in the reference
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if is_dtensor(p) else g for p, g in zip(leaves, grads)]
        it = iter(grads)
        # the gradients as a tree of the params' structure (the leaves
        # were taken in sorted key order)
        tree = _unflatten(params, it)
        return tree, {k: full(v.detach()) for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                             Dict]:
        params = state.params
        n = tcfg.microbatches
        if n > 1:
            b = next(iter(batch.values())).shape[0]
            assert b % n == 0, (b, n)
            mb = b // n
            gsum, per = None, []
            for i in range(n):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                grads, metrics = single(params, micro)
                if gsum is None:
                    gsum = tree_map(lambda g: g.float(), grads)
                else:
                    tree_map(lambda a, g: a.add_(g), gsum, grads)
                per.append(metrics)
                del grads
            grads = tree_map(lambda g: g / n, gsum)
            metrics = {k: torch.stack([m[k] for m in per]).mean()
                       for k in per[0]}
        else:
            grads, metrics = single(params, batch)

        with replicate_plain(tree_leaves(params)[0]):
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state.opt, params)
        metrics = dict(metrics, **{k: full(v) for k, v in opt_metrics.items()})
        return TrainState(new_params, new_opt, next_rng(state.rng)), metrics

    return train_step


def _unflatten(tree, it):
    """``tree``'s structure filled from ``it`` in sorted key order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)
