#!/usr/bin/env python
"""Generate docs/torch/RAISING.md — the traced-PyTorch -> TensorIR raising
guide.

Every transcript and every row of the raisability table is produced by
actually running the port's raiser (via the ``reproc`` driver or
``raise_model_blocks``) in-process, so the document cannot drift from
the compiler's real behaviour: ``tests/test_torch_docs.py`` regenerates
it and fails on any diff.

    PYTHONPATH=src python -m repro_torch.scripts.gen_raising_md > docs/torch/RAISING.md
"""

from __future__ import annotations

import importlib
import sys

from repro_torch.configs.base import ARCHS
from repro_torch.scripts._docgen import block

raising = importlib.import_module("repro_torch.core.raise")


def raisability_table() -> str:
    """One row per config: which forward-pass blocks raise, and why the
    rest don't (first ATen op outside the vocabulary)."""
    lines = ["| config | raised blocks | blocked blocks (first unraisable ATen op) |",
             "|---|---|---|"]
    for arch in ARCHS:
        reports = raising.raise_model_blocks(arch)
        ok = [r.block for r in reports if r.ok]
        bad = []
        for r in reports:
            if r.ok:
                continue
            prim = "?"
            if r.error and "[primitive: " in r.error:
                prim = r.error.split("[primitive: ")[1].split("]")[0]
            bad.append(f"{r.block} ({prim})")
        lines.append(f"| {arch} | {', '.join(ok)} | {', '.join(bad) or '—'} |")
    return "\n".join(lines)


def main() -> int:
    transcript = block(["--raise", "qwen2_7b:mlp"])
    report = block(["--raise", "mamba2_130m"])
    cosim = block(["--raise", "qwen2_7b:rmsnorm",
                   "--pipeline", "lower{tile_m=8,tile_n=8,tile_k=8}",
                   "--simulate"])
    table = raisability_table()

    print(f"""\
# Raising traced PyTorch into TensorIR

<!-- GENERATED FILE — do not edit.  Regenerate with
       PYTHONPATH=src python -m repro_torch.scripts.gen_raising_md > docs/torch/RAISING.md
     tests/test_torch_docs.py diffs this against live output. -->

The paper's flow starts from an IR produced by someone else's tracer;
the port's equivalent is `repro_torch.core.raise`: it traces a PyTorch
function with `make_fx` into a graph of ATen ops (where the JAX package
walks a jaxpr) and **raises** it into the rank-2 TensorIR that the rest
of the stack (PassManager -> LoopIR -> HwIR -> {{ref, torch, cuda}}
backends, DSE, cosim) already compiles.  Anything the vocabulary cannot
express is rejected with a diagnostic naming the ATen op and the
offending fx node — raising is total-or-loud, never silently wrong.

## Vocabulary

| ATen op(s) | TensorIR |
|---|---|
| `mm`, `bmm` with a batch of 1 (single contraction) | `matmul` |
| `add sub rsub mul div maximum` | binary ewise |
| `exp neg tanh sigmoid sqrt rsqrt log1p abs` | unary ewise |
| `relu silu gelu(approximate="tanh") softplus reciprocal pow(2, 3)` | their ewise sequences |
| `sum` / `amax` / `max.dim` / `mean` over the last axis, `_softmax` | carried `reduce` (+ ewise) |
| `torch.ops.higher_order.scan` of `h = a*h + u` / `cumsum(dim=0)` | carried `scan` (linear / cumsum) |
| `permute` `t` `transpose` swapping two non-unit axes / unit-axis `view` `unsqueeze` `squeeze` `expand` | `transpose` / shape bookkeeping |
| `clone` `alias` `detach` `lift_fresh_copy` `_to_copy` (to a float) ... | identity |

Constants (weights captured by the traced function as `get_attr`
tensors, Python scalars, anything foldable) are folded in numpy while
possible and **lazily materialised** as extra graph inputs (`c0`, `c1`,
...) the first time a non-foldable op consumes them — deduplicated by
value, rebound by `RaisedGraph.bind`.  A composite op raises to the
primitive sequence the JAX package's raiser gives its jax spelling
(`mean` to a sum and a division by the count, `silu` to `sigmoid; mul`),
so the same block prints the same TensorIR from either package.

## Raising one block

`reproc --raise CONFIG:BLOCK` raises one forward-pass region of a
(reduced) model config and prints the TensorIR module; everything the
driver does with a hand-built graph (`--pipeline`, `--emit`,
`--simulate`, `--dse`) composes with it.

{transcript}

## The raisability report

`reproc --raise CONFIG` (no block) prints one line per region: raised
(op/const counts) or the diagnostic explaining why not.

{report}

## Through the rest of the stack

A raised graph is an ordinary TensorIR graph: it lowers, schedules,
emits hardware, and co-simulates against the numpy oracle.

{cosim}

## Raisability across the registry

Generated by raising every block of every config at the reduced shapes
(`raise_model_blocks`); the differential test matrix
(`tests/test_torch_raise.py`) additionally checks every raised block's
TensorIR against the JAX package's raiser byte for byte, and its values
against the traced PyTorch function at 1e-4 on the graph interpreter
and through the compiled ref/torch/cuda backends.

{table}

## API

```python
import repro_torch.core.frontend as fe

rg = fe.raise_fx(fn, (8, 64), (64, 256))      # shapes, arrays or tensors
rg.graph          # TensorIR Graph (args first, then captured consts)
rg.run_ref(x, w)  # graph-interpreter execution
ck = rg.compile(tile={{"m": 8, "n": 8, "k": 8}}, device="cpu")
rg.run_compiled(ck, x, w, backend="torch")    # or "ref", "cuda"
rg.explore(validate_top=1)                    # DSE over the raised region

reports = fe.raise_model_blocks("qwen2_7b")   # the per-config corpus
```

A recurrence is written with `core.raise.scan_hop` (torch's scan
operator, `torch.ops.higher_order.scan`, which traces its body into a
sub-graph).  `raise_fx(..., check_hlo_trips=True)` raises `RaiseError`:
the JAX package cross-checks every raised scan length against the
`while`-loop trip counts of the XLA-optimized HLO, and a traced PyTorch
function compiles to no HLO, so the port has no second view of the
recurrence to check against.""")
    return 0


if __name__ == "__main__":
    sys.exit(main())
