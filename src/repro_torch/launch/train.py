"""Training launcher.

The PyTorch counterpart of ``repro/launch/train.py``.  Runs on the GPU by
default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 8 --seq-len 256 --global-batch 8 --remat full

and on the CPU, at reduced size:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --device cpu --steps 20 --checkpoint-dir "$(mktemp -d)"

On a mesh (``--mesh host``: (world, 1) over the process group, started
as one rank when none exists; ``single`` / ``multi``: the production
meshes, which need 256 / 512 ranks) the state is built as DTensors
directly (``train.step.init_state_sharded``) and batches are sharded over
``batch``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --mesh host --steps 8 --seq-len 256 --global-batch 8 --remat full
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen2-7b --reduced --device cpu --mesh host --steps 3

Under ``torchrun`` (``WORLD_SIZE`` set) the group is started from its
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
NCCL on the card, gloo on the CPU.  With ``--checkpoint-dir`` each rank
writes and reads only its own pieces of the state
(``checkpoint/checkpointer.py``); SIGTERM to any rank stops every rank
after the same step with a checkpoint, and the same command run again
resumes from it.

The schedule defaults to WSD for minicpm (its paper's) and cosine
otherwise, with a warmup of steps / 20; the optimizer is AdamW with weight
decay 0.01.  Weights are random, drawn on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed.sharding import axis_rules, sharding_for
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import schedule as sched
from repro_torch.optim.optimizer import adamw
from repro_torch.train.step import (TrainConfig, init_state,
                                    init_state_sharded, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the ``trainer`` (its ``metrics_history``), the
    final ``state``, the ``model`` and the ``mesh`` (None without one)."""
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
    ap.add_argument("--log-every", type=int, default=10,
                    help="log a step's loss every N steps (and the first)")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

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

    mesh = None
    if args.mesh != "none":
        if os.environ.get("WORLD_SIZE"):
            _init_from_env(device)
        if args.mesh == "host":
            mesh = make_host_mesh(device=device)
        else:
            mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                        device=device)

    shape = "" if mesh is None else f" {tuple(mesh.shape)}"
    print(f"[train] arch={cfg.name} params={model.param_count():,} "
          f"mesh={args.mesh}{shape} steps={args.steps}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    trainer = Trainer(TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, log_every=args.log_every),
        step_fn, pipe)
    trainer.install_preemption_handler()
    if mesh is not None:
        with axis_rules(mesh):
            state = init_state_sharded(model, optimizer, gen, mesh)
            batch = sharding_for("batch -", (args.global_batch,
                                             args.seq_len), mesh)
            state = trainer.run(state, sharding=batch)
    else:
        state = init_state(model, optimizer, gen)
        state = trainer.run(state)
    losses = [m["loss"] for m in trainer.metrics_history]
    if losses:
        print(f"[train] loss first->last: {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps")
        print("[train] losses: " + " ".join(map(repr, losses)))
    return {"trainer": trainer, "state": state, "model": model,
            "mesh": mesh}


def _init_from_env(device: torch.device) -> None:
    """Start the process group from torchrun's environment."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
