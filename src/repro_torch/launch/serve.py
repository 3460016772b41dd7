"""Serving launcher: batched generation with prefill/decode steps.

The PyTorch counterpart of ``repro/launch/serve.py`` (its non-continuous
path).  Runs on the GPU by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --batch 4 --prompt-len 128 --gen 32

and on the CPU, at reduced size, with the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --reduced --device cpu

``--continuous`` serves a deterministic load-generator stream through the
continuous engine instead (one batched decode step across all slots; see
``repro_torch.serve.continuous``) and prints the latency metrics
snapshot:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --continuous --slots 4 --requests 16 --rate 4

Weights are random, drawn on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import Engine, EngineConfig, throughput_stats


def _serve_continuous(cfg, model, params, args) -> Dict[str, Any]:
    from repro_torch.serve import loadgen
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.metrics import ServeMetrics, WallClock

    load = loadgen.LoadConfig(
        num_requests=args.requests, vocab_size=cfg.vocab_size,
        seed=args.seed, rate=args.rate,
        prompt=loadgen.LengthDist("uniform", 4, args.prompt_len),
        output=loadgen.LengthDist("uniform", 2, args.gen))
    metrics = ServeMetrics(WallClock(), slots=args.slots)
    engine = ContinuousEngine(model, params, slots=args.slots,
                              max_len=args.prompt_len + args.gen + 1,
                              temperature=args.temperature, seed=args.seed,
                              queue_limit=args.queue_limit, metrics=metrics)
    for r in loadgen.generate_stream(load):
        while not engine.submit(Request(r.rid, r.prompt, r.max_new)):
            engine.step()                    # backpressure: drain a step
    engine.drain()
    snap = metrics.snapshot()
    print(f"[serve] continuous: {snap['requests']['completed']} requests, "
          f"{snap['tokens']['decode']} tokens, "
          f"{snap['tokens_per_s']:.1f} tok/s, "
          f"ttft p50={snap['ttft']['p50']*1e3:.1f}ms "
          f"p99={snap['ttft']['p99']*1e3:.1f}ms")
    print(json.dumps(snap, indent=2, sort_keys=True))
    return {**snap, "engine": engine}


def stub_embeds(cfg, batch: int, device) -> Optional[torch.Tensor]:
    """The stub frontends' input, as the reference's launcher makes it
    (0.1 everywhere): patch embeddings (B, frontend_len, d_model) for
    ``image_patches``, frame embeddings (B, context, encoder d_model) for
    ``audio_frames``; None for a model without a frontend."""
    if cfg.frontend == "image_patches":
        shape = (batch, cfg.frontend_len, cfg.d_model)
    elif cfg.frontend == "audio_frames":
        shape = (batch, cfg.encoder.context,
                 cfg.encoder.d_model or cfg.d_model)
    else:
        return None
    return torch.full(shape, 0.1, dtype=torch.float32, device=device)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serve one batch, or with ``--continuous`` a load-generator stream;
    returns the throughput stats or the metrics snapshot, plus the
    ``engine`` (which holds the model and its params)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a load-generator stream through the "
                         "continuous engine")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--queue-limit", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = torch.device(args.device)
    max_len = args.prompt_len + args.gen + 1
    model = Model(cfg, RunConfig(max_seq=max_len), device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    print(f"[serve] arch={cfg.name} params={model.param_count():,} "
          f"device={device}")

    if args.continuous:
        return _serve_continuous(cfg, model, params, args)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    eng = Engine(model, params, EngineConfig(max_len=max_len,
                                             temperature=args.temperature,
                                             seed=args.seed))
    ee = stub_embeds(cfg, args.batch, device)
    stats = throughput_stats(eng, prompts, args.gen, extra_embeds=ee)
    print(f"[serve] prefill {prompts.size} tokens in "
          f"{stats['prefill_s']:.4f}s = {stats['prefill_tok_per_s']:.1f} tok/s")
    print(f"[serve] decode {stats['decode_steps']} steps x {args.batch} rows "
          f"in {stats['decode_s']:.4f}s = {stats['decode_tok_per_s']:.1f} tok/s")
    print(f"[serve] {stats['tokens']} new tokens in {stats['wall_s']:.2f}s "
          f"= {stats['tok_per_s']:.1f} tok/s")
    return {**stats, "engine": eng}


if __name__ == "__main__":
    main()
