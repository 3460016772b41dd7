#!/usr/bin/env python
"""Generate docs/torch/SHARING.md from a live outlining + sharing run.

Usage (``tests/test_torch_docs.py`` checks the output is current):
    PYTHONPATH=src python -m repro_torch.scripts.gen_sharing_md > docs/torch/SHARING.md

The transcript, pattern statistics and area tables below come from
real pipeline runs, so the document can never drift from the code
without the test noticing.
"""

import sys

from repro_torch.core import dse, frontend as fe, hw_ir, ir_text, machine_model
from repro_torch.core.machine_model import TPU_V5E
from repro_torch.core.passes import PassManager
from repro_torch.core.pipeline import compile_gemm
from repro_torch.core.rewrite import canonicalize
from repro_torch.core.sharing import set_sharing


def _mlp_module():
    """Two identical matmul+relu layers, tiled — the repeated
    subcircuit the outliner folds."""

    def mlp(x, w1, w2):
        return fe.relu(fe.matmul(fe.relu(fe.matmul(x, w1)), w2))

    g = fe.trace(mlp, [fe.spec((8, 8))] * 3, name="mlp2")
    k = PassManager.parse(
        "lower{tile_m=4,tile_n=4,tile_k=4}").run(g).artifact
    return hw_ir.lower_to_hw(k)


def _row(name, mode, mod):
    cyc = machine_model.cycles(mod, TPU_V5E)
    return (f"| {name} | {mode} | {dse.area(mod)} | {mod.total_lanes()} | "
            f"{mod.register_bits()} | {mod.mux_bits()} | "
            f"{mod.shared_unit_count()} | {len(mod.submodules)} | "
            f"{mod.fsm_state_count()} | {cyc.total} |")


def _clone(mod):
    return ir_text.parse_hw_module(ir_text.print_hw_module(mod))


def area_table():
    rows = ["| subject | mode | area | Σlanes | reg bits | mux bits | "
            "shared | sub-defs | FSM states | cycles |",
            "|---------|------|------|--------|----------|----------|"
            "--------|----------|------------|--------|"]
    subjects = []
    ck = compile_gemm(8, 8, 8, schedule="inner_flattened",
                      want_torch=False, want_cuda=False)
    subjects.append(("gemm8/inner_flattened", ck.hw_module))
    subjects.append(("mlp2 (2 layers)", _mlp_module()))
    for name, mod in subjects:
        base = _clone(mod)
        canonicalize(base)
        rows.append(_row(name, "none", base))
        for mode in ("share", "serialize"):
            m = _clone(base)
            set_sharing(m, mode)
            rows.append(_row(name, mode, m))
    return rows


def transcript():
    out = []
    mod = _mlp_module()
    before = ir_text.print_ir(mod)
    res = PassManager.parse("outline-subcircuits,share-units").run(mod)
    stats = "; ".join(
        f"`{r.name}`: "
        + ir_text.format_pattern_stats(r.pattern_stats)
        for r in res.records)
    after = ir_text.print_ir(res.artifact)

    out.append("A two-layer MLP (`relu(relu(x@w1)@w2)`) tiled 4×4×4 "
               "lowers to a flat module whose two layers are "
               "structurally identical nests — and, uncanonicalized, "
               "one datapath unit per statement:")
    out += ["", "```", before, "```", ""]
    out.append(f"Running `outline-subcircuits,share-units` ({stats}):")
    out += ["", "```", after, "```"]
    return out


def main(out=None) -> int:
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    w("# Hierarchical HwIR — subcircuit outlining and time-multiplexed "
      "resource sharing")
    w()
    w("<!-- GENERATED FILE — do not edit by hand. -->")
    w("<!-- Regenerate with:")
    w("       PYTHONPATH=src python -m repro_torch.scripts.gen_sharing_md "
      "> docs/torch/SHARING.md")
    w("     tests/test_torch_docs.py fails if this file is out of sync. -->")
    w()
    w("Flat HwIR pays for every datapath unit it declares, even when "
      "two FSM states could")
    w("take turns on one adder — and it re-states a repeated subcircuit "
      "at every use site.")
    w("`src/repro_torch/core/sharing.py` adds the two classic remedies as "
      "rewrites on the standard")
    w("driver, and the whole stack (verifier, pricing, simulator, "
      "text format, Verilog")
    w("emitter, DSE) understands the result.")
    w()
    w("## The hierarchical form")
    w()
    w("* **Sub-modules + instances** — `HwModule.submodules` holds "
      "child module definitions;")
    w("  an `inst @sub(operands...)` ctrl step calls one, binding each "
      "operand to the")
    w("  definition's ports by position (the simulator passes numpy "
      "*views*, so writes land")
    w("  in parent storage; both the model and the simulator charge "
      "`call_overhead_cycles`")
    w("  per invocation).  `emit-verilog` emits each definition once "
      "plus real instantiation")
    w("  lines.")
    w("* **Binding table** — `bind VIRT -> PHYS serial=S copies=C` rows "
      "map *virtual* unit")
    w("  names (what ctrl steps reference) onto *physical* declared "
      "units.  `serial > 1`")
    w("  means a wide virtual unit runs on narrower hardware in `S` "
      "beats; the model and")
    w("  simulator charge the identical stall formula "
      "(`seq_loop_overhead_cycles * (S-1) /")
    w("  copies` per dynamic use), so cosim stays symmetric by "
      "construction.")
    w()
    w("## The passes")
    w()
    w("| pass | what it does |")
    w("|------|--------------|")
    w("| `outline-subcircuits` | hashes the canonical textual form of "
      "every ctrl subtree (storages/units/counters anonymized), and "
      "outlines each shape that repeats into one sub-module definition "
      "instanced at every occurrence. |")
    w("| `share-units` | port-conflict-aware binding scheduler: one FSM "
      "state is active per cycle, so units used by *distinct* steps "
      "never conflict — same-kind units fold onto one physical unit "
      "behind an input mux (`max_copies=0`, pure sharing at "
      "`serial=1`), or additionally serialize wide units onto narrow "
      "hardware (`max_copies=1`). |")
    w("| `set-sharing` | the DSE knob: `mode=none|share|serialize` runs "
      "the two passes with the matching scheduler policy. |")
    w()
    w("`canonicalize` prunes orphaned unit declarations, dangling "
      "binding rows and")
    w("un-instanced sub-module definitions under their own stats "
      "(`prune-unused-unit`,")
    w("`prune-unused-module`) — never silently.  `dedupe-units` "
      "refuses to touch a unit")
    w("with a binding row, so serialization accounting survives "
      "canonicalization.")
    w()
    w("## What it costs, honestly")
    w()
    w("`dse.area` prices the hierarchical form: **summed** lanes over "
      "every declared unit")
    w("(sub-module definitions count once however many call sites "
      "instance them), register")
    w("bits, block RAM, stream double buffers, plus **mux overhead** "
      "per extra binding on a")
    w("shared unit.  Serialization shows up in `cycles` — smaller area "
      "is not free:")
    w()
    for row in area_table():
        w(row)
    w()
    w("Pure sharing (`share`) never grows area.  Outlining can: a "
      "sub-module definition is")
    w("separate hardware, so its units are no longer time-shared with "
      "the parent's pool —")
    w("the MLP rows above trade datapath lanes for a smaller FSM and a "
      "single statement of")
    w("each repeated layer.  `benchmarks/area_bench.py` records both "
      "directions in")
    w("`BENCH_area.json`, cosim-gated.")
    w()
    w("## An outlining + sharing run, live")
    w()
    for line in transcript():
        w(line)
    w()
    w("Every shared or serialized module above still co-simulates "
      "against the LoopIR numpy")
    w("oracle at `atol=1e-5` with observed cycles within ±10% of the "
      "model (the `simulate`")
    w("gate), and the printed form round-trips through "
      "`ir_text.parse_hw_module` at fixpoint.")

    return 0


if __name__ == "__main__":
    sys.exit(main())
