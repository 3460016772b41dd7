#!/usr/bin/env python
"""Generate docs/torch/REWRITE.md from the live rewrite-core registries.

Usage (``tests/test_torch_docs.py`` checks the output is current):
    PYTHONPATH=src python -m repro_torch.scripts.gen_rewrite_md > docs/torch/REWRITE.md

Everything below is produced from the actual pattern registries and a
real canonicalization run, so the document can never drift from the
code without the test noticing.
"""

import io
import sys

from repro_torch.core import hw_ir, ir_text, rewrite
from repro_torch.core.passes import PASS_REGISTRY, PassManager
from repro_torch.core.reproc import quickstart_gemm
from repro_torch.core.rewrite import CANONICAL_PATTERNS


def canonical_pattern_table(level: str) -> list:
    rows = ["| pattern | benefit | what it does |",
            "|---------|---------|--------------|"]
    for p in CANONICAL_PATTERNS[level]:
        rows.append(f"| `{p.name}` | {p.benefit} | {p.describe()} |")
    return rows


def ported_pass_table() -> list:
    rows = ["| pass | level | pattern set |",
            "|------|-------|-------------|"]
    for pd in sorted(PASS_REGISTRY.values(), key=lambda pd: pd.name):
        if not pd.patterns or pd.name == "canonicalize":
            continue
        pats = ", ".join(f"`{p}`" for p in pd.patterns)
        rows.append(f"| `{pd.name}` | {pd.level_str} | {pats} |")
    return rows


def live_transcript() -> list:
    """Canonicalize the quickstart GEMM at loop and hw level, full-dim
    tiles (the degenerate spelling the patterns exist for)."""
    g = quickstart_gemm(8, 8, 8)
    pipe = "lower{tile_m=8,tile_n=8,tile_k=8}"
    kernel = PassManager.parse(pipe).run(g).artifact
    before_loop = ir_text.print_ir(kernel)
    res = PassManager.parse("canonicalize").run(kernel)
    after_loop = ir_text.print_ir(res.artifact)
    loop_stats = ir_text.format_pattern_stats(res.records[0].pattern_stats)

    hw_before = hw_ir.lower_to_hw(
        PassManager.parse(pipe).run(quickstart_gemm(8, 8, 8)).artifact)
    before_hw = ir_text.print_ir(hw_before)
    hres = PassManager.parse("canonicalize").run(hw_before)
    after_hw = ir_text.print_ir(hres.artifact)
    hw_stats = ir_text.format_pattern_stats(hres.records[0].pattern_stats)

    out = []
    out.append("The quickstart GEMM lowered with full-dimension tiles "
               "(`reproc --gemm 8x8x8 --pipeline "
               "\"lower{tile_m=8,tile_n=8,tile_k=8},canonicalize\"`) is the "
               "degenerate spelling these patterns exist for — every loop "
               "has extent 1:")
    out.append("")
    out.append("```")
    out.append(before_loop)
    out.append("```")
    out.append("")
    out.append(f"`canonicalize` at loop level ({loop_stats}):")
    out.append("")
    out.append("```")
    out.append(after_loop)
    out.append("```")
    out.append("")
    out.append("Lowering the *uncanonicalized* kernel to hardware instead "
               "(`lower-to-hw`) gives trip-1 sequencers and one datapath "
               "unit per statement:")
    out.append("")
    out.append("```")
    out.append(before_hw)
    out.append("```")
    out.append("")
    out.append(f"`canonicalize` at hw level ({hw_stats}):")
    out.append("")
    out.append("```")
    out.append(after_hw)
    out.append("```")
    return out


def main(out=None) -> int:
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    w("# The rewrite core — one walk/rewrite/canonicalize "
      "infrastructure for all three IRs")
    w()
    w("<!-- GENERATED FILE — do not edit by hand. -->")
    w("<!-- Regenerate with:")
    w("       PYTHONPATH=src python -m repro_torch.scripts.gen_rewrite_md "
      "> docs/torch/REWRITE.md")
    w("     tests/test_torch_docs.py fails if this file is out of sync. -->")
    w()
    w("`src/repro_torch/core/rewrite.py` is the stack's MLIR-pattern-rewrite "
      "analogue: instead of")
    w("every transform hand-rolling its own traversal and "
      "reconstruction, TensorIR, LoopIR")
    w("and HwIR all implement one small structural protocol and share "
      "one greedy fixpoint")
    w("driver.")
    w()
    w("## The structural protocol")
    w()
    w("| method | contract |")
    w("|--------|----------|")
    w("| `children()` | the node's *mutable* child list — `Graph.ops`, "
      "`Kernel.body`, `Loop.body`, `HwModule.ctrl`, `HwLoop.body`; "
      "leaves return `[]`.  The driver splices replacements into this "
      "list in place. |")
    w("| `rebuild(children)` | a same-type copy carrying a new child "
      "list (the functional counterpart). |")
    w("| `is_equivalent(other)` | structural equivalence via the "
      "canonical textual form (`ir_text`): two nodes are equivalent iff "
      "they print identically. |")
    w()
    w("## Patterns and the driver")
    w()
    w("A `Pattern` implements `match_and_rewrite(parent, siblings, i, "
      "root)` and returns")
    w("`None` (no match / already canonical) or `(consumed, "
      "replacement)`.  `benefit` orders")
    w("competing patterns.  `RewriteDriver(patterns).run(root)` sweeps "
      "the tree post-order")
    w("until a full sweep changes nothing (or the iteration cap trips), "
      "returning per-pattern")
    w("hit counts; the `PassManager` collects those counts onto each "
      "pass's `PassRecord`")
    w("(`reproc --timing` and `--dump-after-each` print them).")
    w()
    w("## Canonicalization pattern sets")
    w()
    w("`canonicalize` is registered at **tensor, loop and hw** level — "
      "the one pass that runs")
    w("on any IR artifact.  Its per-level pattern sets (extensible via "
      "`register_canonical_pattern(level)`):")
    for level, title in (("tensor", "TensorIR"), ("loop", "LoopIR"),
                         ("hw", "HwIR")):
        w()
        w(f"### {title}")
        w()
        for row in canonical_pattern_table(level):
            w(row)
    w()
    w("## Ported passes")
    w()
    w("The pre-existing schedule transforms and the HwIR sequencer knob "
      "now run as patterns")
    w("on the same driver (same pass names, same pipeline specs, "
      "cosim-verified semantics):")
    w()
    for row in ported_pass_table():
        w(row)
    w()
    w("The DSE also uses the canonical form: design points whose "
      "canonicalized kernels")
    w("coincide are spellings of one design, and `dse.explore` dedupes "
      "them before pricing")
    w("(every elimination is logged in the result table — no silent "
      "shrinkage).")
    w()
    w("## A canonicalization, live")
    w()
    for line in live_transcript():
        w(line)

    return 0


if __name__ == "__main__":
    sys.exit(main())
