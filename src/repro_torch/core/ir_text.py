"""Textual IR round-trip for the stagecc stack (the `mlir-opt` property).

MLIR's reusability story rests on every level of IR having a canonical
textual form that parses back to an identical module — pipelines can then
be debugged, diffed, golden-tested, and driven from the command line at
any stage.  This module gives TensorIR (``Graph``), LoopIR (``Kernel``)
and HwIR (``HwModule``) that property:

    print_ir(parse_ir(print_ir(x))) == print_ir(x)

``print_graph``/``print_kernel``/``print_hw_module`` are the single
source of truth for the textual form; the ``__str__`` of each IR class
delegates here.

Grammar (by example)::

    stagecc.func @gemm(%arg0: tensor<64x32xfloat32>, %arg1: tensor<32x16xfloat32>) {
      %matmul1 = stagecc.matmul(%arg0, %arg1) : tensor<64x16xfloat32>
      %cast2 = stagecc.cast(%matmul1) {dtype='bfloat16'} : tensor<64x16xbfloat16>
      return %cast2
    }

    stagecc.kernel @gemm(arg0: tensor<64x32xfloat32> @hbm, ...) -> (matmul1) {
      alloc acc1: tensor<16x16xfloat32> @vreg
      for %i1 in [0,4) @grid {
        zero acc1[0, 0 : 16x16]
        for %k3 in [0,2) @seq {
          acc1[0, 0 : 16x16] += mxu.matmul(arg0[i1, k3 : 16x16], arg1[k3, j2 : 16x16])
        }
        matmul1[i1, j2 : 16x16] = vpu.copy(acc1[0, 0 : 16x16])
      }
    }

    stagecc.hw @gemm {
      port in arg0: float32[64x32] @hbm
      reg acc1: float32[16x16]
      unit mxu1: mxu<16x16> x1
      ctrl {
        loop %i1 [4] @fsm {
          step matmul mxu1(acc acc1[0, 0 : 16x16], read arg0[i1, k3 : 16x16], read arg1[k3, j2 : 16x16])
        }
      }
    }

The parser re-runs type inference on every TensorIR op and ``verify()``
on every parsed artifact, so a hand-edited IR file gets the same
diagnostics a pass-produced one would.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple, Union

from .hw_ir import (HwBinding, HwCtrl, HwInstance, HwLoop, HwMem, HwModule,
                    HwOperand, HwPort, HwReg, HwStep, HwUnit, LOOP_CTRL_KINDS)
from .loop_ir import (AffineExpr, Buffer, EwiseTile, FillTile, Kernel, Loop,
                      LoopKind, LoopVar, MatmulTile, MemSpace, ReduceTile,
                      ScanTile, Stmt, TileRef, ZeroTile)
from .tensor_ir import Graph, TensorType

IR = Union[Graph, Kernel, HwModule]


class IRParseError(ValueError):
    """Raised with a line number + message when textual IR is malformed."""

    def __init__(self, lineno: int, line: str, msg: str):
        super().__init__(f"line {lineno}: {msg}\n    {line.strip()}")
        self.lineno = lineno


# --------------------------------------------------------------------------
# printing
# --------------------------------------------------------------------------


def print_type(t: TensorType) -> str:
    # single impl lives on the dataclass; this alias keeps the printer
    # namespace complete
    return str(t)


def print_op(op) -> str:
    ins = ", ".join(f"%{v.name}" for v in op.inputs)
    attrs = ""
    if op.attrs:
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(op.attrs.items()))
        attrs = " {" + kv + "}"
    return (f"%{op.result.name} = stagecc.{op.opname}({ins}){attrs}"
            f" : {print_type(op.result.type)}")


def print_graph(g: Graph) -> str:
    args = ", ".join(f"%{v.name}: {print_type(v.type)}" for v in g.inputs)
    lines = [f"stagecc.func @{g.name}({args}) {{"]
    for op in g.ops:
        lines.append(f"  {print_op(op)}")
    rets = ", ".join(f"%{v.name}" for v in g.outputs)
    lines.append(f"  return {rets}")
    lines.append("}")
    return "\n".join(lines)


def print_kernel(k: Kernel) -> str:
    # Buffer.__str__ is "name: type @space" — the parseable form
    ps = ", ".join(str(b) for b in k.params)
    outs = ", ".join(b.name for b in k.outputs)
    lines = [f"stagecc.kernel @{k.name}({ps}) -> ({outs}) {{"]
    for b in k.scratch:
        lines.append(f"  alloc {b}")
    for s in k.body:
        lines.extend("  " + line for line in print_stmt(s))
    lines.append("}")
    return "\n".join(lines)


def print_affine(e: AffineExpr) -> str:
    parts = [f"{s}*{v}" if s != 1 else v for v, s in e.coeffs]
    if e.const or not parts:
        parts.append(str(e.const))
    return "+".join(parts)


def print_tileref(r: TileRef) -> str:
    idx = ", ".join(print_affine(e) for e in r.index)
    t = "x".join(str(t) for t in r.tile)
    return f"{r.buffer.name}[{idx} : {t}]"


def print_stmt(s: Stmt) -> List[str]:
    if isinstance(s, ZeroTile):
        return [f"zero {print_tileref(s.dst)}"]
    if isinstance(s, FillTile):
        return [f"fill {print_tileref(s.dst)}, {s.value!r}"]
    if isinstance(s, ReduceTile):
        kind = f"{s.kind},acc" if s.accumulate else s.kind
        return [f"reduce<{kind}> {print_tileref(s.dst)}, "
                f"{print_tileref(s.src)}"]
    if isinstance(s, ScanTile):
        refs = ", ".join(print_tileref(r) for r in [s.carry, *s.srcs])
        return [f"scan<{s.kind}> {print_tileref(s.dst)}, {refs}"]
    if isinstance(s, MatmulTile):
        op = "+=" if s.accumulate else "="
        return [f"{print_tileref(s.dst)} {op} mxu.matmul("
                f"{print_tileref(s.lhs)}, {print_tileref(s.rhs)})"]
    if isinstance(s, EwiseTile):
        srcs = ", ".join(print_tileref(r) for r in s.srcs)
        return [f"{print_tileref(s.dst)} = vpu.{s.op}({srcs})"]
    if isinstance(s, Loop):
        lines = [f"for %{s.var.name} in [0,{s.var.extent}) @{s.kind.value} {{"]
        for inner in s.body:
            lines.extend("  " + line for line in print_stmt(inner))
        lines.append("}")
        return lines
    raise TypeError(f"unknown stmt {type(s).__name__}")


# ---- HwIR printing ---------------------------------------------------------


def _print_shape(shape) -> str:
    return "x".join(str(d) for d in shape)


def print_hw_operand(o: HwOperand) -> str:
    # tileref-shaped: "role target[affine-index : tile]" — the index is
    # the operand's address generator over the enclosing loop counters
    idx = ", ".join(print_affine(e) for e in o.index)
    return f"{o.role} {o.target}[{idx} : {_print_shape(o.tile)}]"


def print_hw_ctrl(node: HwCtrl) -> List[str]:
    if isinstance(node, HwStep):
        opnds = ", ".join(print_hw_operand(o) for o in node.operands)
        return [f"step {node.op} {node.unit}({opnds})"]
    if isinstance(node, HwInstance):
        opnds = ", ".join(print_hw_operand(o) for o in node.portmap)
        return [f"inst @{node.module}({opnds})"]
    if isinstance(node, HwLoop):
        lines = [f"loop %{node.counter} [{node.trips}] @{node.kind} {{"]
        for inner in node.body:
            lines.extend("  " + line for line in print_hw_ctrl(inner))
        lines.append("}")
        return lines
    raise TypeError(f"unknown control node {type(node).__name__}")


def _hw_body_lines(m: HwModule) -> List[str]:
    """Declaration + ctrl lines of a module body, unindented — canonical
    order: submodules, ports, regs, mems, units, binds, ctrl."""
    lines: List[str] = []
    for sub in m.submodules:
        lines.append(f"module @{sub.name} {{")
        lines.extend("  " + line for line in _hw_body_lines(sub))
        lines.append("}")
    for p in m.ports:
        lines.append(f"port {p.direction} {p.name}: "
                     f"{p.dtype}[{_print_shape(p.shape)}] @{p.space}")
    for r in m.regs:
        lines.append(f"reg {r.name}: {r.dtype}[{_print_shape(r.shape)}]")
    for mm in m.mems:
        lines.append(f"mem {mm.name}: "
                     f"{mm.dtype}[{_print_shape(mm.shape)}] @vmem")
    for u in m.units:
        lines.append(f"unit {u.name}: {u.kind}<{_print_shape(u.geometry)}>"
                     f" x{u.copies}")
    for b in m.bindings:
        lines.append(f"bind {b.virtual} -> {b.unit} "
                     f"serial={b.serial} copies={b.copies}")
    lines.append("ctrl {")
    for node in m.ctrl:
        lines.extend("  " + line for line in print_hw_ctrl(node))
    lines.append("}")
    return lines


def print_hw_module(m: HwModule) -> str:
    lines = [f"stagecc.hw @{m.name} {{"]
    lines.extend("  " + line for line in _hw_body_lines(m))
    lines.append("}")
    return "\n".join(lines)


def print_ir(x: IR) -> str:
    if isinstance(x, Graph):
        return print_graph(x)
    if isinstance(x, HwModule):
        return print_hw_module(x)
    return print_kernel(x)


def ir_size(x) -> Optional[int]:
    """IR size metric for instrumentation: ops (Graph) / stmts (Kernel) /
    control nodes (HwModule)."""
    if isinstance(x, Graph):
        return len(x.ops)
    if isinstance(x, (Kernel, HwModule)):
        return sum(1 for _ in x.walk())
    return None


def format_pattern_stats(hits: Dict[str, int]) -> str:
    """Canonical rendering of rewrite-pattern hit counts for IR dumps and
    timing tables: ``"drop-unit-loop x3, dedupe-units x1"`` (most-hit
    first, name-sorted on ties; empty string when nothing fired)."""
    return ", ".join(f"{name} x{n}" for name, n in
                     sorted(hits.items(), key=lambda kv: (-kv[1], kv[0])))


# --------------------------------------------------------------------------
# parsing helpers
# --------------------------------------------------------------------------


def _split_top(s: str, sep: str = ",") -> List[str]:
    """Split on ``sep`` at bracket/paren/quote depth 0."""
    parts, depth, token, quote = [], 0, "", None
    for ch in s:
        if quote:
            token += ch
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append(token)
            token = ""
        else:
            token += ch
    if token.strip():
        parts.append(token)
    return [p.strip() for p in parts]


def parse_type(s: str) -> TensorType:
    m = re.fullmatch(r"tensor<(.+)>", s.strip())
    if not m:
        raise ValueError(f"bad tensor type {s!r}")
    parts = m.group(1).split("x")
    dims, dtype = parts[:-1], parts[-1]
    if any(not re.fullmatch(r"\d+", d) for d in dims):
        raise ValueError(f"bad dims in tensor type {s!r}")
    return TensorType(tuple(int(d) for d in dims), dtype)


def _parse_affine(s: str) -> AffineExpr:
    s = s.strip()
    coeffs: List[Tuple[str, int]] = []
    const = 0
    for term in s.split("+"):
        term = term.strip()
        if not term:
            raise ValueError(f"empty term in affine expr {s!r}")
        if "*" in term:
            c, _, v = term.partition("*")
            coeffs.append((v.strip(), int(c)))
        elif re.fullmatch(r"-?\d+", term):
            const += int(term)
        else:
            coeffs.append((term, 1))
    return AffineExpr(tuple(coeffs), const)


# tile group may be empty: rank-0 buffers print as "buf[ : ]"
_TILEREF_RE = re.compile(r"^(\w+)\[(.*) : ([\dx]*)\]$")


def _parse_tileref(s: str, buffers: Dict[str, Buffer]) -> TileRef:
    m = _TILEREF_RE.match(s.strip())
    if not m:
        raise ValueError(f"bad tile ref {s!r}")
    name, idx, tile = m.groups()
    if name not in buffers:
        raise ValueError(f"tile ref names unknown buffer {name!r}")
    index = tuple(_parse_affine(e) for e in _split_top(idx))
    return TileRef(buffers[name], index,
                   tuple(int(t) for t in tile.split("x") if t))


# --------------------------------------------------------------------------
# TensorIR parser
# --------------------------------------------------------------------------

_FUNC_RE = re.compile(r"^stagecc\.func @([\w.\-]+)\((.*)\) \{$")
_OP_RE = re.compile(r"^%([\w.]+) = stagecc\.([\w.\-]+)\((.*?)\)"
                    r"(?: \{(.*)\})? : (.+)$")
_RET_RE = re.compile(r"^return\s*(.*)$")


def parse_graph(text: str) -> Graph:
    lines = [(i + 1, ln.strip()) for i, ln in enumerate(text.splitlines())
             if ln.strip()]
    if not lines:
        raise ValueError("empty TensorIR module")
    lineno, head = lines[0]
    m = _FUNC_RE.match(head)
    if not m:
        raise IRParseError(lineno, head, "expected 'stagecc.func @name(...) {'")
    g = Graph(m.group(1))
    env: Dict[str, "Value"] = {}  # type: ignore[name-defined]
    for arg in _split_top(m.group(2)):
        if not arg:
            continue
        name, _, ty = arg.partition(":")
        name = name.strip().lstrip("%")
        env[name] = g.add_input(name, parse_type(ty))
    saw_return = False
    for lineno, ln in lines[1:]:
        if ln == "}":
            break
        r = _RET_RE.match(ln)
        if r:
            saw_return = True
            for nm in _split_top(r.group(1)):
                nm = nm.lstrip("%")
                if nm not in env:
                    raise IRParseError(lineno, ln, f"return of undefined %{nm}")
            g.set_outputs(*[env[nm.lstrip("%")]
                            for nm in _split_top(r.group(1))])
            continue
        o = _OP_RE.match(ln)
        if not o:
            raise IRParseError(lineno, ln, "expected op, return, or '}'")
        res_name, opname, ins, attrstr, ty = o.groups()
        if res_name in env:
            raise IRParseError(lineno, ln,
                               f"redefinition of %{res_name} (SSA values "
                               f"must be defined once)")
        try:
            inputs = [env[nm.lstrip("%")] for nm in _split_top(ins)]
        except KeyError as e:
            raise IRParseError(lineno, ln, f"use of undefined %{e.args[0]}")
        attrs = {}
        for kv in _split_top(attrstr or ""):
            key, _, val = kv.partition("=")
            try:
                attrs[key.strip()] = ast.literal_eval(val.strip())
            except (ValueError, SyntaxError):
                raise IRParseError(lineno, ln, f"bad attribute {kv!r}")
        try:
            res = g.emit(opname, inputs, **attrs)
        except (KeyError, TypeError) as e:
            raise IRParseError(lineno, ln, str(e))
        declared = parse_type(ty)
        if res.type != declared:
            raise IRParseError(lineno, ln,
                               f"declared type {declared} but op infers {res.type}")
        res.name = res_name
        env[res_name] = res
    if not saw_return:
        raise ValueError(f"func @{g.name} has no return")
    g.verify()
    return g


# --------------------------------------------------------------------------
# LoopIR parser
# --------------------------------------------------------------------------

_KERNEL_RE = re.compile(r"^stagecc\.kernel @([\w.\-]+)\((.*)\)"
                        r" -> \(([^)]*)\) \{$")
_ALLOC_RE = re.compile(r"^alloc (\w+): (tensor<[^>]+>) @(\w+)$")
_FOR_RE = re.compile(r"^for %(\w+) in \[0,(\d+)\) @([\w\-]+) \{$")
_MATMUL_RE = re.compile(r"^(.*?) (\+?=) mxu\.matmul\((.*)\)$")
_EWISE_RE = re.compile(r"^(.*?) = vpu\.(\w+)\((.*)\)$")
_FILL_RE = re.compile(r"^fill (.+)$")
_REDUCE_RE = re.compile(r"^reduce<(\w+)(,acc)?> (.+)$")
_SCAN_RE = re.compile(r"^scan<(\w+)> (.+)$")


def _parse_buffer(decl: str) -> Buffer:
    m = re.fullmatch(r"(\w+): (tensor<[^>]+>) @(\w+)", decl.strip())
    if not m:
        raise ValueError(f"bad buffer declaration {decl!r}")
    name, ty, space = m.groups()
    return Buffer(name, parse_type(ty), MemSpace(space))


def parse_kernel(text: str) -> Kernel:
    lines = [(i + 1, ln.strip()) for i, ln in enumerate(text.splitlines())
             if ln.strip()]
    if not lines:
        raise ValueError("empty LoopIR module")
    lineno, head = lines[0]
    m = _KERNEL_RE.match(head)
    if not m:
        raise IRParseError(lineno, head,
                           "expected 'stagecc.kernel @name(...) -> (...) {'")
    name, params_str, outs_str = m.groups()
    params = [_parse_buffer(p) for p in _split_top(params_str)]
    by_name = {b.name: b for b in params}
    out_names = [o for o in _split_top(outs_str) if o]
    missing = [o for o in out_names if o not in by_name]
    if missing:
        raise IRParseError(lineno, head, f"outputs {missing} are not params")
    outputs = [by_name[o] for o in out_names]
    scratch: List[Buffer] = []

    pos = 1

    def parse_stmt_line(lineno: int, ln: str) -> Stmt:
        mm = _MATMUL_RE.match(ln)
        if mm and " mxu.matmul(" in ln:
            dst, eq, args = mm.groups()
            refs = _split_top(args)
            if len(refs) != 2:
                raise IRParseError(lineno, ln, "mxu.matmul takes 2 operands")
            try:
                return MatmulTile(_parse_tileref(dst, by_name),
                                  _parse_tileref(refs[0], by_name),
                                  _parse_tileref(refs[1], by_name),
                                  accumulate=(eq == "+="))
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        me = _EWISE_RE.match(ln)
        if me:
            dst, op, args = me.groups()
            try:
                return EwiseTile(op, _parse_tileref(dst, by_name),
                                 [_parse_tileref(r, by_name)
                                  for r in _split_top(args)])
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        if ln.startswith("zero "):
            try:
                return ZeroTile(_parse_tileref(ln[len("zero "):], by_name))
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        if (mf := _FILL_RE.match(ln)):
            parts = _split_top(mf.group(1))
            if len(parts) != 2:
                raise IRParseError(lineno, ln, "fill takes 'dst, value'")
            try:
                return FillTile(_parse_tileref(parts[0], by_name),
                                float(parts[1]))
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        if (mr := _REDUCE_RE.match(ln)):
            kind, acc, rest = mr.groups()
            parts = _split_top(rest)
            if len(parts) != 2:
                raise IRParseError(lineno, ln, "reduce takes 'dst, src'")
            try:
                return ReduceTile(kind, _parse_tileref(parts[0], by_name),
                                  _parse_tileref(parts[1], by_name),
                                  accumulate=bool(acc))
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        if (ms := _SCAN_RE.match(ln)):
            kind, rest = ms.groups()
            parts = _split_top(rest)
            if len(parts) < 3:
                raise IRParseError(lineno, ln,
                                   "scan takes 'dst, carry, srcs...'")
            try:
                refs = [_parse_tileref(p, by_name) for p in parts]
                return ScanTile(kind, refs[0], refs[2:], refs[1])
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
        raise IRParseError(lineno, ln, "expected statement")

    def parse_block() -> List[Stmt]:
        nonlocal pos
        stmts: List[Stmt] = []
        while pos < len(lines):
            lineno, ln = lines[pos]
            if ln == "}":
                pos += 1
                return stmts
            a = _ALLOC_RE.match(ln)
            if a:
                bname, ty, space = a.groups()
                buf = Buffer(bname, parse_type(ty), MemSpace(space))
                scratch.append(buf)
                by_name[bname] = buf
                pos += 1
                continue
            f = _FOR_RE.match(ln)
            if f:
                var, extent, kind = f.groups()
                try:
                    lk = LoopKind(kind)
                except ValueError:
                    raise IRParseError(lineno, ln, f"unknown loop kind @{kind}")
                pos += 1
                body = parse_block()
                stmts.append(Loop(LoopVar(var, int(extent)), lk, body))
                continue
            stmts.append(parse_stmt_line(lineno, ln))
            pos += 1
        raise IRParseError(lines[-1][0], lines[-1][1], "unclosed block")

    body = parse_block()
    if pos < len(lines):
        lineno, ln = lines[pos]
        raise IRParseError(lineno, ln, "trailing input after kernel body")
    k = Kernel(name=name, params=params, outputs=outputs, scratch=scratch,
               body=body)
    k.verify()
    return k


# --------------------------------------------------------------------------
# HwIR parser
# --------------------------------------------------------------------------

_HW_RE = re.compile(r"^stagecc\.hw @([\w.\-]+) \{$")
_HW_SUBMODULE_RE = re.compile(r"^module @([\w.\-]+) \{$")
_HW_PORT_RE = re.compile(r"^port (inout|in|out) (\w+): (\w+)\[([\dx]*)\]"
                         r" @(hbm|vmem|vreg)$")
_HW_REG_RE = re.compile(r"^reg (\w+): (\w+)\[([\dx]*)\]$")
_HW_MEM_RE = re.compile(r"^mem (\w+): (\w+)\[([\dx]*)\] @vmem$")
_HW_UNIT_RE = re.compile(r"^unit (\w+): (\w+)<([\dx]*)> x(\d+)$")
_HW_BIND_RE = re.compile(r"^bind (\w+) -> (\w+) serial=(\d+) copies=(\d+)$")
_HW_LOOP_RE = re.compile(r"^loop %(\w+) \[(\d+)\] @(\w+) \{$")
_HW_STEP_RE = re.compile(r"^step ([\w.]+) (\w+)\((.*)\)$")
_HW_INST_RE = re.compile(r"^inst @([\w.\-]+)\((.*)\)$")
_HW_OPERAND_RE = re.compile(r"^(read|write|acc) (\w+)\[(.*) : ([\dx]*)\]$")


def _parse_shape(s: str) -> Tuple[int, ...]:
    return tuple(int(d) for d in s.split("x") if d)


def parse_hw_module(text: str) -> HwModule:
    lines = [(i + 1, ln.strip()) for i, ln in enumerate(text.splitlines())
             if ln.strip()]
    if not lines:
        raise ValueError("empty HwIR module")
    lineno, head = lines[0]
    m = _HW_RE.match(head)
    if not m:
        raise IRParseError(lineno, head, "expected 'stagecc.hw @name {'")
    pos = 1

    def parse_operands(lineno: int, ln: str, args: str) -> List[HwOperand]:
        operands = []
        for part in _split_top(args):
            o = _HW_OPERAND_RE.match(part)
            if not o:
                raise IRParseError(lineno, ln, f"bad operand {part!r}")
            role, target, idx, tile = o.groups()
            try:
                index = tuple(_parse_affine(e) for e in _split_top(idx))
            except ValueError as e:
                raise IRParseError(lineno, ln, str(e))
            operands.append(HwOperand(role, target, _parse_shape(tile),
                                      index))
        return operands

    def parse_step(lineno: int, ln: str) -> HwStep:
        s = _HW_STEP_RE.match(ln)
        if not s:
            raise IRParseError(lineno, ln,
                               "expected 'step', 'inst', 'loop', or '}'")
        op, unit, args = s.groups()
        return HwStep(op, unit, parse_operands(lineno, ln, args))

    def parse_block(mod: HwModule) -> List[HwCtrl]:
        nonlocal pos
        nodes: List[HwCtrl] = []
        while pos < len(lines):
            lineno, ln = lines[pos]
            if ln == "}":
                pos += 1
                return nodes
            f = _HW_LOOP_RE.match(ln)
            if f:
                counter, trips, kind = f.groups()
                if kind not in LOOP_CTRL_KINDS:
                    raise IRParseError(lineno, ln,
                                       f"unknown loop kind @{kind}")
                pos += 1
                nodes.append(HwLoop(counter, int(trips), kind,
                                    parse_block(mod)))
                continue
            inst = _HW_INST_RE.match(ln)
            if inst:
                sub_name, args = inst.groups()
                subs = {s.name: s for s in mod.submodules}
                if sub_name not in subs:
                    declared = ", ".join(sorted(subs)) or "none"
                    raise IRParseError(
                        lineno, ln,
                        f"inst references unknown submodule @{sub_name} "
                        f"(declared submodules: {declared})")
                operands = parse_operands(lineno, ln, args)
                want = len(subs[sub_name].ports)
                if len(operands) != want:
                    raise IRParseError(
                        lineno, ln,
                        f"inst @{sub_name}: port map has {len(operands)} "
                        f"operands but module @{sub_name} declares "
                        f"{want} ports")
                nodes.append(HwInstance(sub_name, operands))
                pos += 1
                continue
            nodes.append(parse_step(lineno, ln))
            pos += 1
        raise IRParseError(lines[-1][0], lines[-1][1], "unclosed block")

    def parse_module_body(name: str) -> HwModule:
        """Parse declarations (submodules, ports, regs, mems, units,
        binds), then ``ctrl { ... }``, then the module's closing brace."""
        nonlocal pos
        mod = HwModule(name=name, ports=[], regs=[], mems=[], units=[],
                       ctrl=[])
        while pos < len(lines):
            lineno, ln = lines[pos]
            if (sm := _HW_SUBMODULE_RE.match(ln)):
                pos += 1
                mod.submodules.append(parse_module_body(sm.group(1)))
                continue
            if (p := _HW_PORT_RE.match(ln)):
                direction, pname, dtype, shape, space = p.groups()
                mod.ports.append(HwPort(pname, direction, dtype,
                                        _parse_shape(shape), space))
            elif (r := _HW_REG_RE.match(ln)):
                rname, dtype, shape = r.groups()
                mod.regs.append(HwReg(rname, dtype, _parse_shape(shape)))
            elif (mm := _HW_MEM_RE.match(ln)):
                mname, dtype, shape = mm.groups()
                mod.mems.append(HwMem(mname, dtype, _parse_shape(shape)))
            elif (u := _HW_UNIT_RE.match(ln)):
                uname, kind, geo, copies = u.groups()
                try:
                    mod.units.append(HwUnit(uname, kind, _parse_shape(geo),
                                            int(copies)))
                except ValueError as e:
                    raise IRParseError(lineno, ln, str(e))
            elif (b := _HW_BIND_RE.match(ln)):
                virt, phys, serial, copies = b.groups()
                if not any(un.name == phys for un in mod.units):
                    declared = ", ".join(un.name for un in mod.units) or "none"
                    raise IRParseError(
                        lineno, ln,
                        f"bind {virt} -> {phys}: no unit named {phys!r} "
                        f"declared (units: {declared})")
                try:
                    mod.bindings.append(HwBinding(virt, phys, int(serial),
                                                  int(copies)))
                except ValueError as e:
                    raise IRParseError(lineno, ln, str(e))
            else:
                break
            pos += 1
        if pos >= len(lines) or lines[pos][1] != "ctrl {":
            lineno, ln = lines[min(pos, len(lines) - 1)]
            raise IRParseError(lineno, ln, "expected declaration or 'ctrl {'")
        pos += 1
        mod.ctrl = parse_block(mod)
        if pos >= len(lines) or lines[pos][1] != "}":
            lineno, ln = lines[min(pos, len(lines) - 1)]
            raise IRParseError(lineno, ln, "expected closing '}' of module")
        pos += 1
        return mod

    mod = parse_module_body(m.group(1))
    if pos < len(lines):
        lineno, ln = lines[pos]
        raise IRParseError(lineno, ln, "trailing input after module")
    try:
        mod.verify()
    except KeyError as e:
        raise ValueError(f"module @{mod.name} does not verify: {e.args[0]}")
    return mod


def parse_ir(text: str) -> IR:
    """Parse a textual module, dispatching on ``stagecc.func`` vs
    ``stagecc.kernel`` vs ``stagecc.hw``."""
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("stagecc.func"):
            return parse_graph(text)
        if ln.startswith("stagecc.kernel"):
            return parse_kernel(text)
        if ln.startswith("stagecc.hw"):
            return parse_hw_module(text)
        raise ValueError(f"unrecognised module header: {ln!r}")
    raise ValueError("empty IR module")
