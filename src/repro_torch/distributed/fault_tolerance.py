"""Failure-domain handling beyond checkpoint/restart.

The PyTorch counterpart of ``repro/distributed/fault_tolerance.py``.
``FailoverRunner`` wraps a train-step callable with restore-on-failure
semantics: any step that raises a recoverable error (device OOM, a
simulated chip loss, a collective timeout surfaced as RuntimeError) rolls
the state back to the last committed checkpoint and replays from there —
the in-process equivalent of a job restart, with the same guarantees
(stateless data pipeline keyed by step => no sample skew).

On a real fleet this sits under a cluster scheduler that also replaces
the failed host; the state machine here (checkpoint -> fail -> restore ->
replay) is the reference's, which is what the tests exercise by
injection.  On a group of more than one rank the ranks agree after each
step whether any of them failed (``any_rank``), so all roll back to the
same commit together and take the same saves and restores.  A step ends by synchronising on its loss (the reference's
``block_until_ready``), so a failure on the device surfaces in the step
that caused it.  The port's optimizer updates the state in place and
``checkpointer.restore(target=state)`` writes the checkpoint back into
the state's own tensors, so a rollback holds one copy of the state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.distributed.sharding import group_size

# torch.cuda.OutOfMemoryError and torch.distributed.DistBackendError are
# RuntimeErrors already
RECOVERABLE = (RuntimeError, ValueError)


@dataclasses.dataclass
class FailoverConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    max_failures: int = 5
    backoff_s: float = 0.0           # real fleets back off; tests don't


def _sync(metrics: Dict) -> None:
    """Wait for the step's device work: read its loss (or first metric)."""
    first = metrics["loss"] if "loss" in metrics else \
        next(iter(metrics.values()))
    if torch.is_tensor(first):
        first.item()


def any_rank(flag: bool, device) -> bool:
    """``flag`` of this process, or on a group of more than one rank
    whether any rank's is set: a MAX all-reduce of one integer on
    ``device`` (the group's: a card for NCCL, the CPU for gloo)."""
    if group_size() == 1:
        return flag
    t = torch.tensor(int(flag), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _device(state) -> torch.device:
    """The device of a state's first tensor (the CPU without one)."""
    from repro_torch.optim.optimizer import tree_leaves
    for leaf in tree_leaves(state):
        if torch.is_tensor(leaf):
            return leaf.device
    return torch.device("cpu")


class FailoverRunner:
    def __init__(self, cfg: FailoverConfig, train_step: Callable,
                 batch_fn: Callable[[int], Dict],
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.log = log_fn
        self.failures = 0
        self.replayed_steps = 0

    def run(self, state, start_step: int, total_steps: int):
        step = start_step
        last_commit = start_step
        # resume if a previous incarnation left a checkpoint
        latest = ckpt.latest_step(self.cfg.checkpoint_dir)
        if latest is not None and latest > step:
            state, extra = ckpt.restore(self.cfg.checkpoint_dir,
                                        target=state)
            step = last_commit = extra["step"]
            self.log(f"[failover] resumed at step {step}")
        device = _device(state)
        while step < total_steps:
            err = None
            try:
                state, metrics = self.train_step(state, self.batch_fn(step))
                _sync(metrics)
            except RECOVERABLE as e:
                err = e
            if any_rank(err is not None, device) and err is None:
                err = RuntimeError("the step failed on another rank")
            if err is None:
                step += 1
                if step % self.cfg.checkpoint_every == 0 or \
                        step == total_steps:
                    ckpt.save(self.cfg.checkpoint_dir, step, state)
                    last_commit = step
            else:
                self.failures += 1
                if self.failures > self.cfg.max_failures:
                    raise RuntimeError(
                        f"exceeded {self.cfg.max_failures} failures") from err
                self.log(f"[failover] step {step} failed "
                         f"({type(err).__name__}: {err}); restoring step "
                         f"{last_commit}")
                if self.cfg.backoff_s:
                    time.sleep(self.cfg.backoff_s)
                if ckpt.latest_step(self.cfg.checkpoint_dir) is not None:
                    state, extra = ckpt.restore(self.cfg.checkpoint_dir,
                                                target=state)
                    self.replayed_steps += step - extra["step"]
                    step = extra["step"]
                else:
                    self.replayed_steps += step - start_step
                    step = start_step
        return state, step
