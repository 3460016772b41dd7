"""Batched serving example: prefill + decode with KV caches.

    python -m repro_torch.examples.serve_lm [--device cpu]
    python -m repro_torch.examples.serve_lm --arch recurrentgemma-2b   # recurrent cache
    python -m repro_torch.examples.serve_lm --arch deepseek-v2-236b    # MLA compressed cache

A reduced same-family config with random weights from a seed, served
through ``serve.engine.Engine`` (each decode step replayed as a CUDA
graph on ``--device cuda``, the default; eager on ``--device cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.serve import stub_embeds
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import Engine, EngineConfig, throughput_stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = reduced(get_config(args.arch))
    max_len = args.prompt_len + args.gen + 1
    model = Model(cfg, RunConfig(max_seq=max_len), device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"family: {cfg.name}  params: {model.param_count():,}")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    eng = Engine(model, params,
                 EngineConfig(max_len=max_len,
                              temperature=args.temperature))
    ee = stub_embeds(cfg, args.batch, device)
    stats = throughput_stats(eng, prompts, args.gen, extra_embeds=ee)
    out = eng.generate(prompts, args.gen, extra_embeds=ee)
    print(f"generated batch {out.shape}; "
          f"{stats['tok_per_s']:.1f} tok/s on {args.device}")
    print("sample row:", out[0, :24], "...")
    return out


if __name__ == "__main__":
    main()
