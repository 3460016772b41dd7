"""End-to-end training driver: train a small LM for a few hundred steps
on the synthetic pipeline, with checkpointing and resume.

    python -m repro_torch.examples.train_lm [--device cpu]   # ~2M params, 200 steps
    python -m repro_torch.examples.train_lm --steps 50       # quicker
    python -m repro_torch.examples.train_lm --arch mamba2-130m   # SSM family

Checkpoints go to ``--ckpt`` (a temporary directory, removed at the end,
when none is given).  The same launcher scales to the full configs on
the card via ``python -m repro_torch.launch.train``.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import schedule as sched
from repro_torch.optim.optimizer import adamw
from repro_torch.train.step import TrainConfig, init_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.ckpt is None:
        with tempfile.TemporaryDirectory(prefix="repro_train_lm-") as d:
            return _train(args, d)
    return _train(args, args.ckpt)


def _train(args, ckpt: str):
    device = torch.device(args.device)
    cfg = reduced(get_config(args.arch), layers=args.layers,
                  d_model=args.d_model, vocab=512)
    model = Model(cfg, RunConfig(max_seq=args.seq_len), device)
    print(f"arch family: {cfg.name}  params: {model.param_count():,}")

    opt = adamw(sched.make("wsd", peak=3e-3,
                           warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps), weight_decay=0.01)
    step = make_train_step(model, opt, TrainConfig(microbatches=2))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=args.seq_len,
                               global_batch=args.batch, seed=0))
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                      checkpoint_dir=ckpt, log_every=20),
        step, pipe)
    trainer.install_preemption_handler()
    state = init_state(model, opt,
                       torch.Generator(device=device).manual_seed(0))
    state = trainer.run(state)

    losses = [m["loss"] for m in trainer.metrics_history]
    if losses:
        k = min(10, max(1, len(losses) // 5))
        print(f"\nloss: {sum(losses[:k])/k:.4f} -> "
              f"{sum(losses[-k:])/k:.4f} over {len(losses)} steps "
              f"(straggler events: {trainer.straggler_events})")
    return losses


if __name__ == "__main__":
    main()
