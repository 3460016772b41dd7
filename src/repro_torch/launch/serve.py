"""Serving launcher: batched generation with prefill/decode steps.

The PyTorch counterpart of ``repro/launch/serve.py`` (its non-continuous
path).  Runs on the GPU by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --batch 4 --prompt-len 128 --gen 32

and on the CPU, at reduced size, with the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --reduced --device cpu

Weights are random, drawn on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import Engine, EngineConfig, throughput_stats


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serve one batch; returns the throughput stats plus the ``engine``
    (which holds the model and its params)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = torch.device(args.device)
    max_len = args.prompt_len + args.gen + 1
    model = Model(cfg, RunConfig(), device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    print(f"[serve] arch={cfg.name} params={model.param_count():,} "
          f"device={device}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    eng = Engine(model, params, EngineConfig(max_len=max_len,
                                             temperature=args.temperature,
                                             seed=args.seed))
    stats = throughput_stats(eng, prompts, args.gen)
    print(f"[serve] prefill {prompts.size} tokens in "
          f"{stats['prefill_s']:.4f}s = {stats['prefill_tok_per_s']:.1f} tok/s")
    print(f"[serve] decode {stats['decode_steps']} steps x {args.batch} rows "
          f"in {stats['decode_s']:.4f}s = {stats['decode_tok_per_s']:.1f} tok/s")
    print(f"[serve] {stats['tokens']} new tokens in {stats['wall_s']:.2f}s "
          f"= {stats['tok_per_s']:.1f} tok/s")
    return {**stats, "engine": eng}


if __name__ == "__main__":
    main()
