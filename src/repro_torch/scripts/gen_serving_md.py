#!/usr/bin/env python
"""Generate docs/torch/SERVING.md — the serving-under-load subsystem guide.

Every transcript is produced by actually running the port's load
generator, the batched continuous engine (on the CPU) and the per-block
compile plan in-process under a virtual clock, so the document cannot
drift from the runtime's real behaviour: ``tests/test_torch_docs.py``
regenerates it and fails on any diff.

    PYTHONPATH=src python -m repro_torch.scripts.gen_serving_md > docs/torch/SERVING.md
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import torch

from repro_torch.serve import loadgen
from repro_torch.serve.compiled import plan_blocks


def loadgen_transcript() -> str:
    cfg = loadgen.LoadConfig(
        num_requests=6, vocab_size=151936, seed=0, process="bursty",
        rate=4.0, burst_rate=32.0,
        prompt=loadgen.LengthDist("uniform", 4, 10),
        output=loadgen.LengthDist("uniform", 2, 6))
    stream = loadgen.generate_stream(cfg)
    lines = [f"// {cfg.describe()}"]
    for r in stream:
        lines.append(f"// rid={r.rid} arrival={r.arrival:.3f}s "
                     f"prompt_len={len(r.prompt)} max_new={r.max_new}")
    lines.append(f"// digest={loadgen.stream_digest(stream)}")
    return "\n".join(lines)


def serve_entry(name: str, *, slots: int, requests: int, rate: float,
                process: str, seed: int, queue_limit: Optional[int],
                prompt_hi: int, out_hi: int, max_len: int) -> Dict:
    """One reduced config serving a load-generator stream through the
    continuous engine on the CPU under a virtual clock (the JAX package's
    ``benchmarks/serve_bench.run_config`` drive loop, which the port has
    no benchmark for yet)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.metrics import ServeMetrics, VirtualClock

    cfg = reduced(get_config(name))
    model = Model(cfg, RunConfig(max_seq=max_len), device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    load = loadgen.LoadConfig(
        num_requests=requests, vocab_size=cfg.vocab_size, seed=seed,
        process=process, rate=rate,
        prompt=loadgen.LengthDist("uniform", 4, prompt_hi),
        output=loadgen.LengthDist("uniform", 2, out_hi))
    stream = loadgen.generate_stream(load)
    clock = VirtualClock()
    metrics = ServeMetrics(clock, slots=slots)
    engine = ContinuousEngine(model, params, slots=slots, max_len=max_len,
                              queue_limit=queue_limit, metrics=metrics)
    i = 0
    while i < len(stream) or engine.busy:
        now = clock.now()
        while i < len(stream) and stream[i].arrival <= now:
            r = stream[i]
            if not engine.submit(Request(r.rid, r.prompt, r.max_new),
                                 arrival=r.arrival):
                break                         # backpressure: head waits
            i += 1
        if engine.step() == 0 and i < len(stream):
            gap = stream[i].arrival - clock.now()    # idle: jump the clock
            if gap > 0:
                clock.advance(gap)
    return {"config": name, "slots": slots,
            "metrics": metrics.snapshot(),
            "requests_completed": len(engine.results)}


def fmt_entry(e: Dict) -> str:
    m = e["metrics"]
    unit = "s" if m["clock"] == "wall" else "step"
    return (f"[serve] {e['config']:16s} slots={e['slots']} "
            f"req={e['requests_completed']}/{m['requests']['submitted']} "
            f"tok/{unit}={m['tokens_per_s']:.1f} "
            f"ttft p50/p99={m['ttft']['p50']:.3g}/{m['ttft']['p99']:.3g} "
            f"tpot p50/p99={m['tpot']['p50']:.3g}/{m['tpot']['p99']:.3g} "
            f"util={m['slot_utilization']:.2f}")


def serve_transcript() -> str:
    entry = serve_entry(
        "qwen2_7b", slots=2, requests=8, rate=6.0, process="poisson",
        seed=0, queue_limit=4, prompt_hi=7, out_hi=5, max_len=32)
    snap = json.dumps(entry["metrics"], indent=2, sort_keys=True)
    return fmt_entry(entry) + "\n" + snap


def plan_transcript() -> str:
    return plan_blocks("qwen2_7b", device="cpu").describe()


def main() -> int:
    lg = loadgen_transcript()
    serve = serve_transcript()
    plan = plan_transcript()

    print(f"""\
# Serving under load

<!-- GENERATED FILE — do not edit.  Regenerate with
       PYTHONPATH=src python -m repro_torch.scripts.gen_serving_md > docs/torch/SERVING.md
     tests/test_torch_docs.py diffs this against live output. -->

The paper measures its compiler by what the generated designs do under
real workloads; the port's equivalent is `repro_torch.serve`: a
serving-under-load subsystem that drives the model registry's configs
with deterministic request streams, batches decode across requests in
ONE decode step (replayed as a CUDA graph on the card), and records
tail latency.

Four layers, each usable alone:

| module | role |
|---|---|
| `repro_torch.serve.loadgen` | replayable workload generator: Poisson/bursty/uniform arrivals, configurable prompt/output length distributions |
| `repro_torch.serve.continuous` | the batched continuous engine: one cache tree with a row a slot, per-row lengths, one batched decode step, async admission queue with backpressure |
| `repro_torch.serve.metrics` | per-request TTFT / TPOT / e2e in streaming log-bucket histograms, queue depth and slot occupancy per step |
| `repro_torch.serve.compiled` | the compiler bridge: per-block compile plan (autotuned schedules, validated, explicit fallbacks) |

`repro_torch.serve.engine` keeps the plain batched `Engine` (prefill +
decode over a fixed batch, EOS rows frozen to `eos_id`) and
`SerialSlotEngine`, the per-slot B=1 continuous loop kept as the
bit-exact differential reference for the batched engine
(`tests/test_torch_continuous_batching.py` asserts identical greedy
token streams on mixed request sets, including `max_new=1`).

## The load generator

A stream is a pure function of its `LoadConfig` — same seed, same
stream, byte for byte (`stream_digest` fingerprints it).  Bursty
arrivals are a two-state MMPP: a base-rate phase and a burst-rate
phase, so queueing behaviour under bursts is reproducible.

```
{lg}
```

## The batched continuous engine

`ContinuousEngine` holds ONE cache tree whose batch axis is the slots
(`transformer.copy_rows` copies a slot's rows), with each slot's length
in a per-row array, so every occupied slot decodes in one batched
forward: each row writes its key and value at its own position and
attends its own valid prefix (`decode_attention`'s per-row `valid`).
Where the JAX package `jax.vmap`s a B=1 step over slot-stacked caches,
the port's step is one batched forward, captured once per static cache
as a CUDA graph (`serve.graphs.DecodeGraph`) and replayed each step on
the card (eager on the CPU).  Admission prefills a request at B=1,
samples its first token, and copies the prefilled cache into a free
slot's rows; an active-slot mask freezes empty slots.  `submit()`
enqueues (with backpressure once `queue_limit` is hit), `step()` admits
+ decodes one token for every occupied slot, `drain()` runs to
completion.

A request with `max_new=1` finishes at admission — the prefill already
sampled its only token, so it never occupies a slot.

## Latency metrics

`ServeMetrics` hooks the request lifecycle (submit -> admit -> first
token -> per-token -> finish) into `StreamingHistogram`s: log-spaced
buckets at 2% growth, so p50/p90/p99 are recovered within ~2% at O(1)
memory.  TTFT is measured from *arrival* (queueing included), TPOT is
the gap between consecutive decode tokens, queue depth and slot
occupancy are sampled once per engine step.  Time comes from a `Clock`:
`WallClock` for real runs, `VirtualClock` (each step advances a fixed
virtual cost) for byte-reproducible transcripts like this one (reduced
qwen2_7b on the CPU, weights from `torch.Generator().manual_seed(0)`):

```
{serve}
```

## The compiler bridge

`plan_blocks(config)` raises every forward-pass block
(`repro_torch.core.raise`), compiles each raisable one through the
PassManager stack under the autotuner's schedule for its dominant
matmul shape (falling back through `tpu_mxu` to the always-legal
nested schedule), validates its eager PyTorch backend against the raised
graph on real inputs, and records explicit plain-torch fallbacks with
reasons; `cuda` says whether the general CUDA emitter produced the
block's `run_cuda` (where the JAX package records its Pallas emission).
`ContinuousEngine(plan=)` keeps the plan as a record of which blocks of
the serving model compile; as in the JAX package, the decode step does
not run them:

```
{plan}
```

## The recorded trajectory

The JAX package's `benchmarks/serve_bench.py` drives sustained mixed
prefill/decode load and writes `BENCH_serve.json` (schema
`serve_bench/v1`) with the compile plan embedded.  The port has no
benchmark yet (its first `benchmark` PR defines its cells); its serving
runs on the card through the launcher and `chip_smoke.py`:

```sh
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --reduced --device cpu \\
    --continuous --slots 4 --requests 16 --rate 4
python3 chip_smoke.py        # phases 4, 6a, 6b on the card
```

## API

```python
from repro_torch.serve import loadgen
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.metrics import ServeMetrics, WallClock

stream = loadgen.generate_stream(loadgen.LoadConfig(num_requests=32))
metrics = ServeMetrics(WallClock(), slots=4)
engine = ContinuousEngine(model, params, slots=4, max_len=256,
                          queue_limit=16, metrics=metrics)
for r in stream:
    while not engine.submit(Request(r.rid, r.prompt, r.max_new)):
        engine.step()                       # backpressure
engine.drain()
print(metrics.snapshot())                   # the latency payload
```

Or from the launcher:

```sh
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --reduced \\
    --continuous --slots 4 --requests 16 --rate 4
```""")
    return 0


if __name__ == "__main__":
    sys.exit(main())
