"""Train-step factory: gradient accumulation over microbatches, remat.

The PyTorch counterpart of ``repro/train/step.py``.  ``make_train_step``
builds the (state, batch) -> (state, metrics) function the trainer and
the launcher run: the loss and its gradients through autograd
(``torch.autograd.grad`` over every param leaf), summed over
``microbatches`` slices of the batch and averaged, then one optimizer
update, which writes the new params and moments in place
(``optim.optimizer``).  ``RunConfig.remat`` checkpoints the stacked
groups of the forward (``models.transformer.forward``).

``TrainState.rng`` is a (2,) uint32 tensor on the host: a seed word and
a counter that each step advances.  Nothing draws from it; the
reference's ``fold_in`` stream cannot be reproduced in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

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
    raise NotImplementedError(
        "state_axes: logical axes for sharding need the port's "
        "distribution layer (ROADMAP A11: Maker mode 'axes', "
        "distributed/sharding.py)")


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def make_train_step(model: Model, optimizer: Optimizer,
                    tcfg: TrainConfig = TrainConfig()
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                            Dict]]:
    if tcfg.grad_compress:
        raise NotImplementedError(
            "TrainConfig(grad_compress=True): the int8 error-feedback "
            "reduction needs the port's distributed/compression.py "
            "(ROADMAP A11)")
    loss_fn = make_loss_fn(model)

    def single(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        # the gradients as a tree of the params' structure (the leaves
        # were taken in sorted key order)
        tree = _unflatten(params, it)
        return tree, {k: v.detach() for k, v in metrics.items()}

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

        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, params)
        metrics = dict(metrics, **opt_metrics)
        return TrainState(new_params, new_opt, next_rng(state.rng)), metrics

    return train_step


def _unflatten(tree, it):
    """``tree``'s structure filled from ``it`` in sorted key order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)
