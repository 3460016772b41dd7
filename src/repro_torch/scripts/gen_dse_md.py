#!/usr/bin/env python
"""Generate docs/torch/DSE.md — the design-space exploration guide.

Every transcript below is produced by actually running the port's
``reproc`` driver (or ``dse.explore``) in-process, so the document cannot
drift from the compiler's real output: ``tests/test_torch_docs.py``
regenerates it and fails on any diff.

    PYTHONPATH=src python -m repro_torch.scripts.gen_dse_md > docs/torch/DSE.md
"""

from __future__ import annotations

import os
import sys
import tempfile

from repro_torch.core import dse, reproc
from repro_torch.scripts._docgen import block


def main() -> int:
    # a fresh cache dir keeps the "N cached" header deterministic (always 0)
    with tempfile.TemporaryDirectory(prefix="stagecc-dse-doc-") as cache:
        old = os.environ.get("STAGECC_DSE_CACHE")
        os.environ["STAGECC_DSE_CACHE"] = cache
        try:
            return _main()
        finally:
            if old is None:
                os.environ.pop("STAGECC_DSE_CACHE")
            else:
                os.environ["STAGECC_DSE_CACHE"] = old


def _main() -> int:
    table = block(["--gemm", "8x8x8", "--epilogue", "none", "--dse=4"])

    g = reproc.quickstart_gemm(8, 8, 8, epilogue="none")
    points = dse.enumerate_points(g)
    fam_rows = "\n".join(
        f"| `{pt.family}` | `{pt.spec}` |"
        for pt in points)

    print(f"""# DSE — design-space exploration over schedules × HwIR

<!-- GENERATED FILE — do not edit by hand. -->
<!-- Regenerate with:
       PYTHONPATH=src python -m repro_torch.scripts.gen_dse_md > docs/torch/DSE.md
     tests/test_torch_docs.py fails if this file is out of date: every
     transcript below is captured from the port's `reproc` driver. -->

The paper's loop is manual: pick a transformation, generate RTL,
simulate it in Vivado, read cycles/utilisation off the reports, repeat.
`repro_torch.core.dse` folds that loop into the compiler:

```
enumerate schedule programs ──► lower each through the real pipeline
  (pass-pipeline specs)          (PassManager → Kernel → HwModule)
        │                               │
        │                        price structurally
        │                        (machine_model.cycles / resources / area)
        ▼                               ▼
  on-disk candidate cache ◄──── cycles × area Pareto frontier
  (keyed: graph, machine,               │
   schedule program, budget)            ▼
                                 validate top-K by co-simulation
                                 (hw_sim.cosim vs the numpy oracle,
                                  observed vs modeled cycles)
```

A **design point** is a *schedule program*: a replayable pass-pipeline
spec over the LoopIR scheduling passes, plus an optional HwIR-level
knob pipeline applied after `lower-to-hw`.  Nothing about a point is
opaque — paste its `SCHEDULE PROGRAM` column into
`reproc --pipeline ...` to replay it.

## The search space

Families instantiated for the 8×8×8 GEMM (loop names, extents and
scratch buffers are discovered from the real nested lowering):

| family | schedule program |
|--------|------------------|
{fam_rows}

The two *paper* points are `nested` (time-multiplexed `@fsm` baseline)
and `inner_flattened` (the paper's §III unrolling).  Beyond them:

* `split_unroll` — partial spatial replication: `split{{var,factor}}`
  then `unroll` the inner loop ⇒ the datapath unit is replicated
  `factor`× (`HwUnit.copies`), trading area for removed control;
* `simd` — `vectorize` a loop onto VPU lanes.  Only generated where
  **legal**: every tile written under the loop must be indexed by the
  loop variable (GEMM's K loop is a reduction — unrollable, *not*
  vectorizable — so the pure GEMM has no `simd` points);
* `interchange` — swap a perfectly-nested pair (only enumerated when
  the extents differ, i.e. when it changes the trip structure);
* `vmem_acc` — memory-space placement: push the accumulator from
  `@vreg` into `@vmem` (fewer register bits, one BRAM block);
* `stream_outer` / `flat_stream` — the HwIR-level knob: re-sequence the
  outer `@fsm` loop as `@stream` (`set-sequencer`), buying the grid
  sequencer's double-buffered DMA overlap at the price of ping-pong
  buffer area;
* `tpu_mxu` / `tpu_mxu_kgrid` — the TPU-native grid-mapped MXU tilings
  (`fuse-epilogue` + `grid`), one point per tile edge.

## Pricing and the frontier

Each point lowers to a real `HwModule` and is priced structurally —
`machine_model.cycles` (FSM transitions, unit latencies, port traffic)
and `machine_model.resources`, folded into one scalar **area**
(`dse.area`): datapath lanes × {dse.LANE_AREA} FF/LUT-equivalents +
register bits + block-quantized BRAM bits (18Kb blocks, {dse.BRAM_BIT_DISCOUNT}×
denser than FFs) + `@stream` double-buffer RAM.  Feasibility is checked
against a `ResourceBudget` (the FPGA-size analogue; defaults derive
from the machine).  Candidates that survive land on the strict
cycles × area Pareto frontier, and the top-K frontier points are
**validated** exactly the way the paper validates RTL: `hw_sim.cosim`
executes the module cycle-accurately and checks outputs against the
numpy oracle and observed cycles against the model.

## The CLI

```sh
PYTHONPATH=src python -m repro_torch.core.reproc --gemm 32x32x32 \\
    --epilogue none --dse --pareto-csv pareto.csv
```

{table}

Pricing results are memoized on disk — re-running reports
`(N cached)` and only new design points recompile.  The cache key is
(graph text, machine, schedule program, budget); set
`STAGECC_DSE_CACHE` to relocate it.

## The other entry points

* **library** — `dse.explore(graph, machine=..., validate_top=4)` →
  `DseResult` (`.frontier`, `.best()`, `.table()`, `.to_csv()`);
* **artifact** — `compile_gemm(...).explore(validate_top=4)` explores
  around a compiled kernel's graph on its machine;
* **pipeline** — the `dse` *pass*:
  `reproc --gemm 16x16x16 --pipeline "dse,lower-to-hw,emit-verilog"`
  searches, then keeps lowering the winning schedule;
* **benchmark** — the JAX package's `python -m benchmarks.pareto` prints
  the frontier CSV for the paper sizes plus an ASCII cycles×area
  scatter; the port has no benchmarks yet, and its `dse` prices the
  same TPU v5e machine model, so the frontier is the same.

See also [ARCHITECTURE.md](../ARCHITECTURE.md) (where DSE sits in the
stack), [PASSES.md](PASSES.md) (the `dse`, `set-space` and
`set-sequencer` passes), and `tests/test_torch_search.py` (the port's
frontiers, tables and CSVs against the JAX package's, byte for
byte).""")
    return 0


if __name__ == "__main__":
    sys.exit(main())
