"""Training loop with fault tolerance: checkpoint / restart, preemption
handling, straggler detection.

The PyTorch counterpart of ``repro/train/trainer.py``:

  * **preemption** — SIGTERM (``install_preemption_handler``) ends the
    loop after the current step with a final checkpoint; the next run
    resumes from the latest commit (``Trainer.run`` is re-entrant).  On
    a group of more than one rank the signal reaches the ranks at
    different moments, so before each step they combine their flags
    (``fault_tolerance.any_rank``: a MAX all-reduce of one integer) and
    all stop after the same step, then save once together;
  * **stragglers** — per-step wall time is tracked with an EMA; steps
    slower than ``straggler_factor`` x the EMA are logged and counted;
  * **data** — the pipeline is stateless; the step counter in the
    manifest is the only data state.

Each step ends by reading its loss to the host (``.item()``), so a
step's wall time covers its device work.  Batches go to the params'
device.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed.fault_tolerance import any_rank
from repro_torch.optim.optimizer import tree_leaves
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_ema: float = 0.9


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 pipeline: Pipeline,
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.log = log_fn
        self._preempted = False
        self.metrics_history: List[Dict[str, float]] = []
        self.straggler_events = 0

    # ---- fault-tolerance hooks ----------------------------------------------

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def _maybe_restore(self, state: TrainState):
        d = self.cfg.checkpoint_dir
        if not d:
            return state, 0
        step = ckpt.latest_step(d)
        if step is None:
            return state, 0
        state, extra = ckpt.restore(d, step=step, target=state)
        self.log(f"[trainer] resumed from step {extra['step']} "
                 f"({_io_text(ckpt.io['restore'], 'read')})")
        return state, extra["step"]

    def _save(self, state: TrainState, step: int):
        if self.cfg.checkpoint_dir:
            path = ckpt.save(self.cfg.checkpoint_dir, step, state,
                             extra={"data_step": step},
                             keep=self.cfg.keep_checkpoints)
            self.log(f"[trainer] checkpointed step {step} -> {path} "
                     f"({_io_text(ckpt.io['save'], 'written')})")

    def _stop(self, device) -> bool:
        """Whether the loop ends here: this process was preempted, or on
        a group any rank was (the same answer on every rank, which then
        counts as preempted; the flag is only ever set, so a signal
        that lands meanwhile is not lost)."""
        agreed = any_rank(self._preempted, device)
        if agreed:
            self._preempted = True
        return agreed

    # ---- loop ----------------------------------------------------------------

    def run(self, state: TrainState, start_step: int = 0,
            sharding=None) -> TrainState:
        """Train to ``total_steps``; ``sharding`` places each batch
        (``Pipeline.torch_batch``)."""
        state, resumed = self._maybe_restore(state)
        step = max(start_step, resumed)
        device = tree_leaves(state.params)[0].device
        ema = None
        first_step = True
        while step < self.cfg.total_steps and not self._stop(device):
            batch = self.pipeline.torch_batch(step, device, sharding)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = metrics["loss"].item()
            dt = time.perf_counter() - t0
            # straggler detection (the first step carries the kernels'
            # builds and allocator growth and is excluded from the EMA)
            if ema is not None and dt > self.cfg.straggler_factor * ema:
                self.straggler_events += 1
                self.log(f"[trainer] straggler step {step}: {dt:.3f}s "
                         f"(ema {ema:.3f}s)")
            if first_step:
                first_step = False
            else:
                ema = dt if ema is None else (self.cfg.straggler_ema * ema
                                              + (1 - self.cfg.straggler_ema)
                                              * dt)
            step += 1
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["loss"] = loss
            scalars["step_time_s"] = dt
            self.metrics_history.append(scalars)
            if step % self.cfg.log_every == 0 or step == 1:
                self.log(f"[trainer] step {step}: loss={scalars['loss']:.4f} "
                         f"lr={scalars.get('lr', 0):.2e} {dt*1e3:.0f}ms")
            if step % self.cfg.checkpoint_every == 0:
                self._save(state, step)
        if self._preempted:
            self.log(f"[trainer] preempted at step {step}; checkpointing")
            self._save(state, step)
        elif self.cfg.checkpoint_dir:
            self._save(state, step)
        return state


def _io_text(rec: Dict[str, float], verb: str) -> str:
    """A checkpoint's ``ckpt.io`` record as the log prints it."""
    return (f"{rec['bytes'] / 1e9:.3f} GB {verb} by this process in "
            f"{rec['seconds']:.2f} s; peak host memory "
            f"+{rec['peak_rss_growth'] / 1e9:.3f} GB")
