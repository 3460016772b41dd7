"""Training launcher.

The PyTorch counterpart of ``repro/launch/train.py``.  Runs on the GPU by
default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 8 --seq-len 256 --global-batch 8 --remat full

and on the CPU, at reduced size:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --device cpu --steps 20 --checkpoint-dir "$(mktemp -d)"

The schedule defaults to WSD for minicpm (its paper's) and cosine
otherwise, with a warmup of steps / 20; the optimizer is AdamW with weight
decay 0.01.  Weights are random, drawn on the device from ``--seed``.
``--mesh`` other than ``none`` needs the port's distribution layer
(ROADMAP A11).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import schedule as sched
from repro_torch.optim.optimizer import adamw
from repro_torch.train.step import TrainConfig, init_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the ``trainer`` (its ``metrics_history``), the
    final ``state`` and the ``model``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default=None, choices=[None, "cosine", "wsd"])
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single", "multi"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: device meshes need the port's "
            "distribution layer (ROADMAP A11)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = torch.device(args.device)
    model = Model(cfg, RunConfig(max_seq=args.seq_len, remat=args.remat),
                  device)

    sname = args.schedule or ("wsd" if cfg.name.startswith("minicpm")
                              else "cosine")
    lr = sched.make(sname, peak=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps)
    optimizer = adamw(lr, weight_decay=0.01)
    step_fn = make_train_step(model, optimizer,
                              TrainConfig(microbatches=args.microbatches))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=args.seq_len,
                               global_batch=args.global_batch,
                               seed=args.seed))

    print(f"[train] arch={cfg.name} params={model.param_count():,} "
          f"mesh={args.mesh} steps={args.steps}")
    state = init_state(model, optimizer,
                       torch.Generator(device=device).manual_seed(args.seed))
    trainer = Trainer(TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir), step_fn, pipe)
    trainer.install_preemption_handler()
    state = trainer.run(state)
    losses = [m["loss"] for m in trainer.metrics_history]
    if losses:
        print(f"[train] loss first->last: {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps")
    return {"trainer": trainer, "state": state, "model": model}


if __name__ == "__main__":
    main()
