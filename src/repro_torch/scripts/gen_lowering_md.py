#!/usr/bin/env python
"""Generate docs/torch/LOWERING.md — the end-to-end lowering tutorial.

Every IR dump in the tutorial is produced by actually running the port's
``reproc`` driver (or the models it feeds) in-process, so the document
cannot drift from the compiler's real output: ``tests/test_torch_docs.py``
regenerates it and fails on any diff.

    PYTHONPATH=src python -m repro_torch.scripts.gen_lowering_md > docs/torch/LOWERING.md
"""

from __future__ import annotations

import sys

from repro_torch.core import machine_model
from repro_torch.core.pipeline import compile_gemm
from repro_torch.scripts._docgen import block

#: the worked example — the paper's 4x4 scalar GEMM (TABLE I, first row)
GEMM = "4x4x4"
PAPER_NESTED, PAPER_FLAT = 1_498, 1_114


def main() -> int:
    g = ["--gemm", GEMM, "--epilogue", "none"]

    tensor = block(g)
    loop_nested = block(g + ["--pipeline", "lower"])
    loop_flat = block(g + ["--pipeline", "lower,flatten-inner"])
    hw = block(g + ["--pipeline", "lower,flatten-inner,lower-to-hw"])
    verilog = block(g + ["--pipeline", "lower,flatten-inner", "--emit",
                         "verilog"], lang="verilog")

    cosim = block(g + ["--pipeline", "lower", "--emit", "hw",
                       "--simulate", "host"])

    # the serving-kernel walkthrough: flash attention through the stack
    fl = ["--kernel", "flash:4x8x4"]
    t4 = "tile_m=4,tile_n=4,tile_k=4"
    flash_tensor = block(fl)
    flash_loop = block(fl + ["--pipeline", f"lower{{{t4}}}"])
    flash_sched = block(
        fl + ["--pipeline", f"lower{{{t4}}},fuse-epilogue,grid{{vars=2}}"])

    from repro_torch.core import frontend as fe
    from repro_torch.core.passes import PassError, run_pipeline
    try:
        run_pipeline(fe.ssd_scan_graph(8, 2, 4),
                     f"lower{{{t4}}},grid{{vars=2}}")
        raise RuntimeError("gridding the scan axis should have diagnosed")
    except PassError as e:
        ssd_diag = str(e)

    nested = compile_gemm(4, 4, 4, schedule="nested",
                          want_torch=False, want_cuda=False)
    flat = compile_gemm(4, 4, 4, schedule="inner_flattened",
                        want_torch=False, want_cuda=False)
    ncyc = machine_model.cycles(nested.hw_module)
    fcyc = machine_model.cycles(flat.hw_module)
    nres = machine_model.resources(nested.hw_module)
    fres = machine_model.resources(flat.hw_module)

    print(f"""# Lowering, end to end — one GEMM through every level

<!-- GENERATED FILE — do not edit by hand. -->
<!-- Regenerate with:
       PYTHONPATH=src python -m repro_torch.scripts.gen_lowering_md > docs/torch/LOWERING.md
     tests/test_torch_docs.py fails if this file is out of date: every IR
     dump below is captured from the port's `reproc` driver. -->

This tutorial walks the paper's 4×4 GEMM case study (TABLE I, first
row) through all of stagecc's IR levels.  Each dump below is the exact
output of the shown command — run them yourself from the repo root.

The stack (the paper's Fig. 1, see [ARCHITECTURE.md](../ARCHITECTURE.md)):

```
python (traced) → TensorIR → LoopIR → scheduled LoopIR → HwIR → Verilog-style RTL
                                                          ├→ structural cycles / resources
                                                          └→ HwSim: cycle-accurate execution
                                                              (+ host/crossbar co-simulation)
```

## Level 1 — TensorIR (the MLIR role)

The driver's built-in GEMM module, printed with no pipeline (`reproc`
acts as a round-trip printer, like `mlir-opt` with no passes):

{tensor}

## Level 2 — LoopIR (the Calyx role)

`lower` turns each tensor op into a *nested sequential* loop nest over
tiles — the paper's time-multiplexed baseline ("nested for-loop").
Control (`@seq` loops) and storage (`@hbm` / `@vreg` buffers) are now
explicit:

{loop_nested}

## Level 2, scheduled — the paper's §III transformation

`flatten-inner` is the paper's single studied optimisation: the
innermost loop is fully unrolled so its datapath is replicated
spatially (`@seq` → `@unrolled`, "Inner Flattened for-loop"):

{loop_flat}

## Level 3 — HwIR (the Calyx-to-RTL role)

`lower-to-hw` lowers the scheduled kernel to an FSM + datapath hardware
module: HBM params become memory **port**s, `@vreg` scratch becomes
**reg**ister banks, every leaf statement binds to a datapath **unit**
(`mac` scalar multiply-accumulate here; `mxu` for systolic tiles, `vpu`
for elementwise), and loops become hardware sequencers — `@fsm`
(time-multiplexed, one FSM transition per trip) or `@unroll` (spatially
replicated copies, note `x4` on the MAC unit):

{hw}

Like the two levels above it, HwIR has a canonical textual form:
`print(parse(print(hw)))` is a fixpoint (see `tests/test_hw_ir.py`).

## Level 4 — Verilog-style RTL (the paper's emission stage)

`emit-verilog` pretty-prints the module as RTL text — FSM state
encoding, loop counters, register banks, generate-replicated units.
(`--emit=verilog` is the shortcut that appends the default remaining
lowerings to whatever the pipeline produced; `--pipeline
"...,lower-to-hw,emit-verilog"` spells the same thing as passes.)

{verilog}

## Reading TABLE I / Fig. 3 off the hardware

`machine_model.cycles` / `resources` walk the HwIR structure — FSM
transitions per trip, unit latencies, memory-port traffic, register
bits, datapath lanes × copies — the quantities the paper reads off
Vivado for its generated RTL:

```python
from repro_torch.core import machine_model
from repro_torch.core.pipeline import compile_gemm

nested = compile_gemm(4, 4, 4, schedule="nested").hw_module
flat   = compile_gemm(4, 4, 4, schedule="inner_flattened").hw_module
machine_model.cycles(nested)     # {ncyc}
machine_model.cycles(flat)       # {fcyc}
machine_model.resources(nested)  # {nres}
machine_model.resources(flat)    # {fres}
```

Paper (TABLE I, 4×4): nested {PAPER_NESTED:,} cycles, inner-flattened
{PAPER_FLAT:,} cycles — a 1.34× gain for proportional hardware growth;
the structural model lands within 15% absolute with the same mechanism:
flattening removes the k-loop's FSM transitions (control
{ncyc.control} → {fcyc.control}) while compute stays port-limited
({ncyc.compute} cycles in both), and the datapath grows from
{nres.compute_lanes} to {fres.compute_lanes} MAC lanes
(`benchmarks/table1_cycles.py`, `benchmarks/fig3_resources.py`).

## Simulate it — the hardware level executes

Pricing a module is one half of the Vivado role; *running* it is the
other.  `--simulate` executes the hardware module cycle-accurately in
`hw_sim` (operand address generators resolve to real numpy slices, each
datapath invocation and FSM transition is charged its latency) and
co-simulates: outputs are checked against the LoopIR numpy oracle and
the **observed** cycle count lands next to the **modeled** one.
`--simulate host` additionally wraps the run in the paper's crossbar
integration — the host programs the generated CSR block, DMAs the input
buffers in, kicks `CTRL.start`, polls `STATUS.done`, and DMAs the
result back, with every phase priced in cycles:

{cosim}

The observed count matches the modeled one because both walk the same
hardware with the same unit latencies (`machine_model.step_cycles` is
the single source of truth) — a real divergence is a scheduling bug,
and the `simulate` *pass* (`--pipeline "...,lower-to-hw,simulate"`)
fails the pipeline on exactly that, or on non-finite outputs.  From
Python the same checks are one call:

```python
ck = compile_gemm(4, 4, 4, schedule="nested")
rep = ck.simulate(a, b)          # SimMismatch on numeric divergence
rep.observed_cycles, rep.modeled_cycles, rep.max_abs_err
tr = ck.simulate_host(a, b)      # full DMA/CSR/poll transaction
tr.total_cycles - tr.device_cycles   # the crossbar's toll
```

Add `--trace` for the per-state retired-event trace and `--vcd FILE`
for a waveform-style dump of the schedule
(`benchmarks/table1_cycles.py` reports modeled-vs-simulated columns for
every TABLE I size).

## The serving kernels — carried state through the same pipeline

GEMM's loops are embarrassingly tileable; the serving kernels are not.
Flash attention's online softmax carries a running max/sum across the
key axis, and the Mamba SSD scan carries its state across time — the
first structures in the stack where *which* loop a schedule may
parallelise is a legality question.  Both are plain TensorIR modules
(`--kernel flash|decode|ssd`), built with the carried `reduce` / `scan`
ops:

{flash_tensor}

`lower` gives each carried reduction the online-softmax shape: a `fill`
initialises the VREG statistic to the reduction identity (`-1e+30` for
max), a *sequential* carry loop threads it through `reduce<max,acc>`
steps, and a copy materialises the result — same pattern for `sum`,
and `scan<linear>` threads its carry row across the time loop:

{flash_loop}

Schedules apply unchanged — `fuse-epilogue` packs the elementwise tail
into the producer nest and `grid{{vars=2}}` maps the outer rows onto the
kernel's grid of blocks — but the carry loops stay `@seq`.  A schedule that tried to
grid or vectorise a carry axis is refused with a diagnostic instead of
silently miscompiling (pinned in `tests/test_loop_ir_passes.py`):

```
$ PYTHONPATH=src python -m repro_torch.core.reproc --kernel ssd:8x2x4 \\
      --pipeline "lower{{tile_m=4,tile_n=4,tile_k=4}},grid{{vars=2}}"
error: {ssd_diag}
```

{flash_sched}

From here the flow is identical to the GEMM's: `lower-to-hw` maps
`reduce`/`scan` steps onto VPU units (priced by the machine model,
executed bit-exactly by HwSim against the numpy oracle), and the
general CUDA emitter (`backend_cuda.emit_general`, where the JAX package
emits a `pl.pallas_call` a nest) turns every nest into one generated CUDA
kernel on `kernels/csrc/stagecc_stage.cuh` —
`tests/test_torch_compiled_kernels.py` runs the differential matrix on
the CPU (the stages' plain versions vs the reference's Pallas kernels in
interpret mode, the hand-written kernels and closed-form numpy) and
`chip_smoke.py` phase 11 runs the kernels on the card against them.

## Where to go next

* [ARCHITECTURE.md](../ARCHITECTURE.md) — stage-by-stage map of the stack
* [PASSES.md](PASSES.md) — the (generated) pass reference
* `python -m repro_torch.examples.quickstart` — the same flow driven
  from Python
* `python -m repro_torch.examples.extend_pipeline` — registering new
  ops/passes from outside the core""")
    return 0


if __name__ == "__main__":
    sys.exit(main())
