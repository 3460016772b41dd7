"""``reproc`` — command-line pipeline driver, the stack's ``mlir-opt``.

Run a pass pipeline over textual IR (or a built-in GEMM) and inspect the
IR after every stage::

    python -m repro_torch.core.reproc --pipeline "lower;flatten" --dump-after-each
    python -m repro_torch.core.reproc --input kernel.ir --pipeline "grid{vars=2}"
    python -m repro_torch.core.reproc --gemm 256x128x64 --epilogue bias_relu \
        --pipeline "lower{tile_m=32,tile_n=32,tile_k=32},fuse-epilogue" --timing
    python -m repro_torch.core.reproc --emit=verilog        # built-in GEMM -> RTL
    python -m repro_torch.core.reproc --gemm 4x4x4 --emit=hw
    python -m repro_torch.core.reproc --gemm 4x4x4 --pipeline lower --simulate
    python -m repro_torch.core.reproc --gemm 8x8x8 --pipeline lower \
        --simulate host --trace --vcd /tmp/gemm.vcd   # full transaction
    python -m repro_torch.core.reproc --gemm 32x32x32 --epilogue none \
        --dse --pareto-csv pareto.csv   # design-space exploration
    python -m repro_torch.core.reproc --list-passes --markdown
    python -m repro_torch.core.reproc --raise qwen2_7b          # raisability report
    python -m repro_torch.core.reproc --raise qwen2_7b:mlp      # raised TensorIR

Pipeline stages separate on ``;`` or ``,``; stage arguments go in braces
(``lower{tile_m=128}``).  Without ``--input``, the driver traces the
quickstart GEMM (``relu(a @ b + bias)``, 64x32x16) as its input module.
``--emit=LEVEL`` lowers the final artifact to the requested level
(``tensor`` | ``loop`` | ``hw`` | ``verilog``) with default passes
before printing, so ``--emit=verilog`` alone walks the whole stack.
``--list-passes --markdown`` prints the pass reference as markdown.
``--raise CONFIG:BLOCK`` raises one forward-pass block of a model config
from traced PyTorch (``core/raise.py``) into TensorIR and uses it as the
input module; ``--raise CONFIG`` prints the per-block raisability report.

The port of ``repro/core/reproc.py``: the same flags, output and exit
codes.  Its backend passes are ``emit-torch`` and ``emit-cuda``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from . import frontend as fe
from . import host_bridge, hw_ir, hw_sim, ir_text, lowering, machine_model
from .frontend import spec, trace
from .hw_ir import HwModule
from .loop_ir import Kernel
from .passes import (LEVELS, PASS_ALIASES, PASS_REGISTRY, PassError,
                     PassManager)
from .tensor_ir import Graph


def quickstart_gemm(m: int = 64, k: int = 32, n: int = 16,
                    epilogue: str = "bias_relu") -> Graph:
    """The quickstart's traced GEMM, the driver's default input module."""
    if epilogue == "bias_relu":
        def f(a, b, bias):
            return fe.relu(fe.matmul(a, b) + bias)
        specs = [spec((m, k)), spec((k, n)), spec((n,))]
    elif epilogue == "relu":
        def f(a, b):
            return fe.relu(fe.matmul(a, b))
        specs = [spec((m, k)), spec((k, n))]
    elif epilogue == "none":
        def f(a, b):
            return fe.matmul(a, b)
        specs = [spec((m, k)), spec((k, n))]
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return trace(f, specs, name=f"gemm_{m}x{n}x{k}_{epilogue}")


def passes_markdown() -> str:
    """The pass reference of this package's registry, as markdown."""
    lines = [
        "# Pass reference",
        "",
        "<!-- GENERATED FILE — do not edit by hand. -->",
        "<!-- Regenerate with:",
        "       PYTHONPATH=src python -m repro_torch.core.reproc"
        " --list-passes --markdown -->",
        "",
        "Passes registered in `repro_torch.core.passes.PASS_REGISTRY`, grouped by",
        "the IR level they operate on.  Invoke them through a pipeline spec",
        "(`PassManager.parse(\"lower{tile_m=128},flatten-inner\")` or",
        "`python -m repro_torch.core.reproc --pipeline ...`) or programmatically",
        "(`PassManager().add(\"lower\", tile_m=128)`).",
        "",
    ]
    level_blurb = {
        "tensor": "Consume **TensorIR** (`Graph`); `lower` produces LoopIR.",
        "loop": "Transform **LoopIR** (`Kernel`) in place; each re-verifies. "
                "`lower-to-hw` produces HwIR.",
        "hw": "Consume **HwIR** (`HwModule`); `emit-verilog` prints RTL text.",
        "backend": "Terminal: turn a scheduled `Kernel` into a callable.",
    }

    def pattern_cell(pd, level):
        # a multi-level pass lists only the patterns of the section's level
        names = [p for p in pd.pattern_names
                 if ":" not in p or p.startswith(f"{level}:")]
        names = [p.split(":", 1)[-1] for p in names]
        return ", ".join(f"`{n}`" for n in names) if names else "—"

    for level in LEVELS:
        defs = sorted((pd for pd in PASS_REGISTRY.values()
                       if level in pd.levels), key=lambda pd: pd.name)
        if not defs:
            continue
        lines.append(f"## {level}-level passes")
        lines.append("")
        lines.append(level_blurb[level])
        lines.append("")
        lines.append("| pass | rewrite patterns | description |")
        lines.append("|------|------------------|-------------|")
        for pd in defs:
            note = (" *(runs at every IR level)*"
                    if len(pd.levels) > 1 else "")
            lines.append(f"| `{pd.name}` | {pattern_cell(pd, level)} | "
                         f"{pd.doc}{note} |")
        lines.append("")
    lines.append("Passes built on the unified rewrite core "
                 "(`repro_torch/core/rewrite.py`) list their pattern set; "
                 "see the JAX package's docs/REWRITE.md for the pattern "
                 "reference and per-pattern hit statistics.")
    lines.append("")
    if PASS_ALIASES:
        lines.append("## Aliases")
        lines.append("")
        lines.append("| alias | pass |")
        lines.append("|-------|------|")
        for alias in sorted(PASS_ALIASES):
            lines.append(f"| `{alias}` | `{PASS_ALIASES[alias]}` |")
        lines.append("")
    return "\n".join(lines)


def _list_passes_text() -> str:
    rows = [f"{'PASS':18s} {'LEVEL':15s} {'PATTERNS':9s} DESCRIPTION"]
    order = {lv: i for i, lv in enumerate(LEVELS)}
    for pd in sorted(PASS_REGISTRY.values(),
                     key=lambda pd: (order[pd.levels[0]], pd.name)):
        npat = str(len(pd.pattern_names)) if pd.pattern_names else "-"
        rows.append(f"{pd.name:18s} {pd.level_str:15s} {npat:9s} {pd.doc}")
    for alias in sorted(PASS_ALIASES):
        rows.append(f"{alias:18s} {'alias':15s} {'':9s} "
                    f"-> {PASS_ALIASES[alias]}")
    return "\n".join(rows)


_EMIT_LEVELS = ("tensor", "loop", "hw", "verilog")


def coerce_to_level(art, target: str):
    """Lower ``art`` with default passes until it reaches ``target``.

    ``--emit=verilog`` is ``hw`` plus the Verilog pretty-printer, so the
    bare driver (no ``--pipeline``) still walks the whole stack:
    TensorIR -> LoopIR (scalar nested) -> HwIR -> RTL text.
    """
    if target == "verilog":
        if isinstance(art, str):        # pipeline already ended in emit-verilog
            return art
        return hw_ir.emit_verilog(coerce_to_level(art, "hw"))
    rank = {"tensor": 0, "loop": 1, "hw": 2}[target]
    if isinstance(art, Graph) and rank >= 1:
        art = lowering.lower_graph(art)
    if isinstance(art, Kernel) and rank >= 2:
        art = hw_ir.lower_to_hw(art)
    have = {Graph: 0, Kernel: 1, HwModule: 2}.get(type(art), -1)
    if have != rank:
        raise ValueError(
            f"cannot emit {target!r} from a {type(art).__name__} artifact "
            f"(the pipeline already lowered past that level)")
    return art


def simulate_report(args, art) -> str:
    """The ``--simulate`` section: co-simulate the artifact's hardware.

    A Graph/Kernel artifact is lowered to hardware first (keeping the
    LoopIR stage as the numeric oracle); an HwModule artifact simulates
    directly (no oracle — the numeric check is skipped with a note).
    """
    if not isinstance(art, (Graph, Kernel, HwModule)):
        raise ValueError(
            "cannot simulate emitted text; end the pipeline at or before "
            "lower-to-hw (or drop --emit=verilog)")
    kernel = None
    if isinstance(art, Graph):
        art = lowering.lower_graph(art)
    if isinstance(art, Kernel):
        kernel = art
        hw = hw_ir.lower_to_hw(kernel)
    else:
        hw = art

    inputs = hw_sim.random_inputs(hw, seed=args.seed)
    want_trace = args.trace or bool(args.vcd)
    rep = hw_sim.cosim(hw, kernel, inputs, trace=want_trace)
    lines = [f"// {rep.summary()}"]
    lines.append(f"//   observed: {rep.sim.cycles}")
    lines.append(f"//   modeled:  {machine_model.cycles(hw)}")
    if kernel is None:
        lines.append("//   (no LoopIR stage in scope: numeric check "
                     "against the numpy oracle skipped)")
    if args.simulate == "host":
        xbar = _crossbar_from(args)
        # reuse the co-sim's device run rather than simulating twice
        tr = host_bridge.run_transaction(hw, inputs, crossbar=xbar,
                                         sim=rep.sim)
        lines.extend("// " + ln for ln in tr.summary().splitlines())
    if args.simulate == "fabric":
        lines.extend("// " + ln for ln in fabric_report(args, hw, kernel))
    if args.trace:
        lines.append(rep.sim.format_trace())
    if args.vcd:
        with open(args.vcd, "w") as f:
            f.write(rep.sim.vcd())
        lines.append(f"// vcd dump written to {args.vcd}")
    return "\n".join(lines)


def _crossbar_from(args) -> host_bridge.Crossbar:
    """The crossbar the --simulate host/fabric sections price over:
    a named preset (--crossbar) or the latency/width flag pair."""
    if args.crossbar:
        return host_bridge.crossbar_preset(args.crossbar)
    return host_bridge.Crossbar(
        "axi4", data_width_bits=args.crossbar_width,
        latency_cycles=args.crossbar_latency)


def fabric_report(args, hw, kernel) -> List[str]:
    """The ``--simulate fabric`` section: schedule a saturating request
    stream over N copies of the module behind one shared crossbar and
    print serialized-baseline vs contention-aware-overlap pricing, from
    both the fabric machine model and the fabric event simulator."""
    import dataclasses as _dc

    from . import fabric as fabric_mod

    xbar = _crossbar_from(args)
    fab = fabric_mod.make_fleet(
        {hw.name: (hw, kernel)}, copies={hw.name: args.fabric_slots},
        crossbar=xbar, policy=args.fabric_policy)
    base = fabric_mod.transaction_cost(
        hw, xbar, machine_model.cycles(hw).total).total
    mix = fabric_mod.TrafficMix(
        "cli", ((hw.name, 1.0),), num_requests=args.fabric_requests,
        rate=1.0, seed=args.seed)
    # offer ~2x the whole fleet's capacity so contention is visible
    mix = _dc.replace(mix, cycles_per_unit=fabric_mod.
                      saturating_cycles_per_unit(
                          mix, base, load_factor=2.0 * args.fabric_slots))
    stream = fabric_mod.fabric_stream(mix)
    ser = fab.model(stream, overlap=False)
    ovl = fab.model(stream, overlap=True)
    sim = fab.simulate(stream, overlap=True, seed=args.seed)
    dev = (100.0 * abs(sim.requests_per_s - ovl.requests_per_s)
           / max(ovl.requests_per_s, 1e-12))
    lines = [f"fabric: {args.fabric_slots}x {hw.name} over {xbar.name} "
             f"({xbar.data_width_bits}b), policy={args.fabric_policy}, "
             f"{len(stream)} requests"]
    lines += ser.summary().splitlines()
    lines += ovl.summary().splitlines()
    lines += sim.summary().splitlines()
    lines.append(f"overlap speedup {ovl.requests_per_s / ser.requests_per_s:.2f}x "
                 f"over serialized dispatch; "
                 f"event sim deviates {dev:.2f}% from the machine model")
    return lines


_KERNEL_GRAPHS = {
    # name -> (builder, default dims) — the serving kernels as TensorIR
    "flash": (fe.flash_attention_graph, (8, 16, 4)),
    "decode": (fe.decode_attention_graph, (4, 16, 4)),
    "ssd": (fe.ssd_scan_graph, (16, 2, 4)),
}


def kernel_graph(spec_str: str) -> Graph:
    """Build a serving-kernel input module from ``NAME`` or ``NAME:AxBxC``
    (``flash:8x16x4`` — dims as the builder's positional arguments)."""
    name, _, dims = spec_str.partition(":")
    if name not in _KERNEL_GRAPHS:
        raise ValueError(
            f"--kernel expects one of {', '.join(_KERNEL_GRAPHS)} "
            f"(optionally NAME:AxBxC), got {spec_str!r}")
    builder, default = _KERNEL_GRAPHS[name]
    if dims:
        try:
            args = tuple(int(d) for d in dims.lower().split("x"))
        except ValueError:
            raise ValueError(f"--kernel dims must be AxBxC, got {dims!r}")
        if len(args) != len(default):
            raise ValueError(
                f"--kernel {name} takes {len(default)} dims, got {dims!r}")
    else:
        args = default
    return builder(*args)


def raised_block_graph(spec_str: str) -> Graph:
    """Raise one model block named as ``CONFIG:BLOCK`` (see ``--raise``)
    into its TensorIR graph."""
    import importlib
    raising = importlib.import_module("repro_torch.core.raise")
    config, _, block = spec_str.partition(":")
    reports = raising.raise_model_blocks(config)
    by_name = {r.block: r for r in reports}
    if block not in by_name:
        raise ValueError(
            f"--raise: config {config!r} has no block {block!r}; "
            f"available: {', '.join(sorted(by_name))}")
    rep = by_name[block]
    if rep.raised is None:
        raise ValueError(
            f"--raise: block {config}:{block} is not raisable:\n"
            f"{rep.error}")
    return rep.raised.graph


def _load_input(args) -> "ir_text.IR":
    if args.input:
        with open(args.input) as f:
            return ir_text.parse_ir(f.read())
    if args.kernel:
        return kernel_graph(args.kernel)
    if args.raise_spec:
        return raised_block_graph(args.raise_spec)
    m, n, k = 64, 16, 32
    if args.gemm:
        try:
            m, n, k = (int(d) for d in args.gemm.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--gemm expects MxNxK, got {args.gemm!r}")
    return quickstart_gemm(m=m, k=k, n=n, epilogue=args.epilogue)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.reproc",
        description="stagecc pipeline driver (mlir-opt analogue): run a "
                    "pass pipeline over textual TensorIR/LoopIR/HwIR and "
                    "dump the IR at any stage.")
    p.add_argument("--pipeline", metavar="SPEC", default="",
                   help="pipeline spec, e.g. 'lower{tile_m=32};flatten' "
                        "(stages separate on ';' or ',')")
    p.add_argument("--input", metavar="FILE",
                   help="textual IR module to start from (stagecc.func or "
                        "stagecc.kernel); default: the quickstart GEMM")
    p.add_argument("--gemm", metavar="MxNxK",
                   help="use an MxNxK GEMM as the input module (default "
                        "64x16x32, the quickstart shape)")
    p.add_argument("--epilogue", choices=("none", "relu", "bias_relu"),
                   default="bias_relu",
                   help="epilogue for the built-in GEMM input")
    p.add_argument("--kernel", metavar="NAME[:AxBxC]",
                   help="use a serving kernel as the input module: "
                        "flash (SQxSKxD), decode (REPxSMAXxHD), or "
                        "ssd (SxPxN), e.g. 'flash:8x16x4'; dims default "
                        "to a small smoke shape")
    p.add_argument("--raise", dest="raise_spec", metavar="CONFIG[:BLOCK]",
                   help="raise a (reduced) model config's forward-pass "
                        "block from traced PyTorch into TensorIR and use "
                        "it as the input module, e.g. 'qwen2_7b:mlp'; "
                        "without :BLOCK, print the per-block raisability "
                        "report (raised graphs + unraisable-op "
                        "diagnostics) and exit")
    p.add_argument("--emit", metavar="LEVEL",
                   help="lower the final artifact to LEVEL (tensor|loop|"
                        "hw|verilog) with default passes before printing")
    p.add_argument("--dse", nargs="?", const=4, type=int, metavar="N",
                   help="design-space exploration: search schedule "
                        "programs x HwIR knobs over the input module, "
                        "print the cycles x area Pareto frontier, and "
                        "co-simulate the N fastest frontier points "
                        "against the numpy oracle (default N=4; N=0 "
                        "skips validation)")
    p.add_argument("--pareto-csv", metavar="FILE",
                   help="with --dse: write every priced candidate "
                        "(plus frontier/validation flags) to FILE as CSV")
    p.add_argument("--simulate", nargs="?", const="kernel",
                   choices=("kernel", "host", "fabric"),
                   metavar="{kernel,host,fabric}",
                   help="cycle-accurately simulate the final artifact's "
                        "hardware module on seeded random inputs and print "
                        "a co-sim report (observed vs modeled cycles, "
                        "numeric check against the numpy oracle); 'host' "
                        "additionally runs the full crossbar transaction "
                        "(DMA in -> CSR start -> poll -> DMA out); "
                        "'fabric' schedules a saturating request stream "
                        "over --fabric-slots copies of the module behind "
                        "one shared crossbar (serialized baseline vs "
                        "contention-aware overlap, model vs event sim)")
    p.add_argument("--trace", action="store_true",
                   help="with --simulate: print the per-state retired-"
                        "event trace")
    p.add_argument("--vcd", metavar="FILE",
                   help="with --simulate: write a VCD-style dump of the "
                        "schedule to FILE")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for --simulate / --dse validation "
                        "inputs (default 0)")
    p.add_argument("--crossbar-latency", type=int, default=24,
                   help="with --simulate host/fabric: DMA handshake "
                        "latency in cycles (default 24)")
    p.add_argument("--crossbar-width", type=int, default=128,
                   help="with --simulate host/fabric: crossbar data width "
                        "in bits (default 128)")
    p.add_argument("--crossbar", metavar="PRESET",
                   help="with --simulate host/fabric: use a named crossbar "
                        "preset (axi4, axi4_lite) instead of the "
                        "--crossbar-latency/--crossbar-width pair")
    p.add_argument("--fabric-slots", type=int, default=2,
                   help="with --simulate fabric: accelerator copies "
                        "behind the shared crossbar (default 2)")
    p.add_argument("--fabric-requests", type=int, default=12,
                   help="with --simulate fabric: request-stream length "
                        "(default 12)")
    p.add_argument("--fabric-policy", default="round_robin",
                   choices=("round_robin", "priority"),
                   help="with --simulate fabric: crossbar arbitration "
                        "policy (default round_robin)")
    p.add_argument("--dump-after-each", action="store_true",
                   help="print the IR (with wall time and size delta) "
                        "after every pass")
    p.add_argument("--no-verify", action="store_true",
                   help="skip inter-pass IR verification")
    p.add_argument("--timing", action="store_true",
                   help="print the per-pass timing table")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="write the final IR to FILE instead of stdout")
    p.add_argument("--list-passes", action="store_true",
                   help="list registered passes and exit")
    p.add_argument("--markdown", action="store_true",
                   help="with --list-passes: emit the pass reference as "
                        "markdown")
    return p


def main(argv: Optional[List[str]] = None, out=None) -> int:
    args = build_parser().parse_args(argv)
    close_out = False
    if out is None:
        if args.output:
            out = open(args.output, "w")
            close_out = True
        else:
            out = sys.stdout
    try:
        return _run(args, out)
    except BrokenPipeError:
        # routine when dump output is piped into head/less; exit quietly
        # (redirect stdout to devnull so the interpreter's final flush
        # doesn't print its own traceback)
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
    finally:
        if close_out:
            out.close()


def _run(args, out) -> int:

    if args.markdown and not args.list_passes:
        print("error: --markdown requires --list-passes", file=sys.stderr)
        return 2
    if args.emit and args.emit not in _EMIT_LEVELS:
        import difflib
        close = difflib.get_close_matches(args.emit, _EMIT_LEVELS, n=1,
                                          cutoff=0.5)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        print(f"error: --emit: invalid choice {args.emit!r}{hint} "
              f"(choose from {', '.join(_EMIT_LEVELS)})", file=sys.stderr)
        return 2
    if args.kernel:
        kname = args.kernel.partition(":")[0]
        if kname not in _KERNEL_GRAPHS:
            import difflib
            close = difflib.get_close_matches(kname, _KERNEL_GRAPHS, n=1,
                                              cutoff=0.5)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            print(f"error: --kernel: unknown kernel {kname!r}{hint} "
                  f"(choose from {', '.join(_KERNEL_GRAPHS)})",
                  file=sys.stderr)
            return 2
    if args.kernel and (args.gemm or args.input):
        other = "--gemm" if args.gemm else "--input"
        print(f"error: --kernel and {other} both name an input module; "
              f"pick one", file=sys.stderr)
        return 2
    if args.raise_spec and (args.kernel or args.gemm or args.input):
        other = ("--kernel" if args.kernel
                 else "--gemm" if args.gemm else "--input")
        print(f"error: --raise and {other} both name an input module; "
              f"pick one", file=sys.stderr)
        return 2
    if args.raise_spec and ":" not in args.raise_spec:
        if args.pipeline or args.emit or args.simulate \
                or args.dse is not None:
            print("error: '--raise CONFIG' prints the raisability report "
                  "and takes no pipeline; name a block as CONFIG:BLOCK to "
                  "get an input module", file=sys.stderr)
            return 2
        import importlib
        raising = importlib.import_module("repro_torch.core.raise")
        try:
            print(raising.raising_report(args.raise_spec), file=out, end="")
        except (KeyError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        return 0
    if (args.trace or args.vcd) and not args.simulate:
        flag = "--trace" if args.trace else "--vcd"
        print(f"error: {flag} requires --simulate", file=sys.stderr)
        return 2
    if args.crossbar is not None:
        key = args.crossbar.strip().lower()
        if key not in host_bridge.CROSSBAR_PRESETS:
            import difflib
            close = difflib.get_close_matches(
                key, host_bridge.CROSSBAR_PRESETS, n=1, cutoff=0.5)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            print(f"error: --crossbar: unknown preset "
                  f"{args.crossbar!r}{hint} (choose from "
                  f"{', '.join(host_bridge.CROSSBAR_PRESETS)})",
                  file=sys.stderr)
            return 2
        if args.simulate not in ("host", "fabric"):
            print("error: --crossbar requires --simulate host or "
                  "--simulate fabric", file=sys.stderr)
            return 2
    if args.pareto_csv and args.dse is None:
        print("error: --pareto-csv requires --dse", file=sys.stderr)
        return 2
    if args.dse is not None:
        for flag, given in (("--pipeline", args.pipeline),
                            ("--simulate", args.simulate),
                            ("--emit", args.emit)):
            if given:
                print(f"error: --dse explores/validates pipelines itself "
                      f"and cannot be combined with {flag}",
                      file=sys.stderr)
                return 2
    if args.list_passes:
        print(passes_markdown() if args.markdown else _list_passes_text(),
              file=out)
        return 0

    try:
        art = _load_input(args)
    except (OSError, TypeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.dse is not None:
        from . import dse

        if not isinstance(art, Graph):
            print("error: --dse needs a TensorIR module as input "
                  f"(got {type(art).__name__}); start from --gemm or a "
                  "stagecc.func --input", file=sys.stderr)
            return 1
        try:
            res = dse.explore(art, validate_top=args.dse, seed=args.seed)
        except (PassError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(res.table(), file=out)
        if args.pareto_csv:
            with open(args.pareto_csv, "w") as f:
                f.write(res.to_csv())
            print(f"// pareto csv written to {args.pareto_csv}", file=out)
        bad = [v for v in res.validations if not v.ok]
        return 1 if bad else 0

    def render(final) -> str:
        if args.emit:
            final = coerce_to_level(final, args.emit)
        if isinstance(final, str):
            return final
        if isinstance(final, (Graph, Kernel, HwModule)):
            return ir_text.print_ir(final)
        return f"// backend artifact: {final!r}"

    if not args.pipeline:
        # no pipeline: round-trip printer (mlir-opt with no passes), plus
        # any default lowering --emit asks for
        try:
            print(render(art), file=out)
            if args.simulate:
                print(simulate_report(args, art), file=out)
        except (PassError, ValueError, hw_sim.SimError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        return 0

    try:
        pm = PassManager.parse(args.pipeline, verify=not args.no_verify,
                               dump_after_each=args.dump_after_each)
        result = pm.run(art)
    except (KeyError, ValueError) as e:
        print(f"error: {e.args[0] if isinstance(e, KeyError) else e}",
              file=sys.stderr)
        return 1

    if args.dump_after_each:
        print(f"// ===== input ({type(art).__name__}, "
              f"size {ir_text.ir_size(art)}) =====", file=out)
        print(ir_text.print_ir(art), file=out)
        for r in result.records:
            delta = ("" if r.size_after is None or r.size_before is None
                     else f", size {r.size_before} -> {r.size_after}")
            pats = ("" if not r.pattern_stats else ", patterns: "
                    + ir_text.format_pattern_stats(r.pattern_stats))
            print(f"// ===== after {r.name} ({r.level}, "
                  f"{r.wall_ms:.3f} ms{delta}{pats}) =====", file=out)
            print(r.dump_after, file=out)
        if args.emit:
            try:
                print(f"// ===== emitted ({args.emit}) =====", file=out)
                print(render(result.artifact), file=out)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
    else:
        try:
            print(render(result.artifact), file=out)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if args.simulate:
        try:
            print(simulate_report(args, result.artifact), file=out)
        except (ValueError, hw_sim.SimError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if args.timing:
        print("// per-pass timing", file=out)
        for line in result.timing_table().splitlines():
            print(f"//   {line}", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
