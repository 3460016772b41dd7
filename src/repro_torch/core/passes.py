"""Multi-level pass manager — the reusability/extensibility layer.

The paper encapsulates its whole lowering flow "using a script"; here the
script is either a declarative pipeline string, e.g.::

    lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue,grid{vars=2},emit-cuda

or a programmatically-built :class:`PassManager`::

    pm = PassManager().add("lower", tile_m=128).add("flatten-inner")
    result = pm.run(graph)

mirroring MLIR's ``PassManager`` / ``mlir-opt`` split.  The manager owns
an ordered list of registered passes with declared IR levels, checks that
each pass receives an artifact of its level (a ``tensor`` pass gets a
``Graph``, a ``loop`` or ``backend`` pass gets a ``Kernel``, an ``hw``
pass gets an ``HwModule``), re-runs the IR verifier between passes, and
records per-pass instrumentation (wall time, IR-size delta, optional
before/after textual dumps).

New passes register with ``@register_pass`` exactly like new ops register
with ``register_op`` — third parties extend the pipeline without touching
the core (the paper's stated goal for the infrastructure).
"""

from __future__ import annotations

import dataclasses
import difflib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import (backend_cuda, backend_ref, backend_torch, hw_ir, lowering,
               rewrite, schedule)
from .hw_ir import HwModule
from .loop_ir import Kernel, LoopKind, MemSpace
from .tensor_ir import Graph

Artifact = Union[Graph, Kernel, HwModule, Callable, str]

#: IR levels in lowering order; a pass's level names the IR it *consumes*
#: (``lower`` is a tensor pass producing LoopIR, ``lower-to-hw`` a loop
#: pass producing HwIR, ``emit-verilog`` an hw pass producing text).
LEVELS = ("tensor", "loop", "hw", "backend")


class PassError(ValueError):
    """A pass failed or produced IR that does not verify."""


@dataclasses.dataclass(frozen=True)
class PassDef:
    name: str
    #: the IR level(s) the pass consumes — a single name, or a tuple for
    #: level-agnostic passes (``canonicalize`` runs at tensor/loop/hw)
    level: Union[str, Tuple[str, ...]]
    fn: Callable[..., Artifact]
    doc: str = ""
    #: names of the rewrite patterns the pass is built from — a tuple,
    #: or a zero-arg callable resolved on read so registries that grow
    #: after import (``register_canonical_pattern``) stay visible in
    #: ``reproc --list-passes`` and the generated docs
    patterns: Union[Tuple[str, ...], Callable[[], Tuple[str, ...]]] = ()

    @property
    def pattern_names(self) -> Tuple[str, ...]:
        return tuple(self.patterns() if callable(self.patterns)
                     else self.patterns)

    @property
    def levels(self) -> Tuple[str, ...]:
        return (self.level,) if isinstance(self.level, str) else self.level

    @property
    def level_str(self) -> str:
        return "/".join(self.levels)


PASS_REGISTRY: Dict[str, PassDef] = {}

#: alternate spellings accepted by pipeline specs and the reproc driver
PASS_ALIASES: Dict[str, str] = {
    "flatten": "flatten-inner",
    "fuse": "fuse-epilogue",
}


def register_pass(name: str, level: Union[str, Tuple[str, ...]],
                  doc: str = "", patterns=()):
    """Register ``fn`` as pass ``name`` at IR ``level`` (a level name or
    a tuple of levels for level-agnostic passes).

    ``doc`` defaults to the first line of the function's docstring so the
    generated pass reference (``reproc --list-passes``) is never empty.
    ``patterns`` names the rewrite patterns the pass is built from —
    pass a zero-arg callable to resolve the list lazily (used by
    ``canonicalize``, whose pattern registry is runtime-extensible).
    """
    levels = (level,) if isinstance(level, str) else tuple(level)
    for lv in levels:
        if lv not in LEVELS:
            raise ValueError(f"pass {name!r}: level must be one of {LEVELS}, "
                             f"got {lv!r}")

    def deco(fn):
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        d = doc.strip()
        if not d:
            lines = (fn.__doc__ or "").strip().splitlines()
            d = lines[0].strip() if lines else ""
        PASS_REGISTRY[name] = PassDef(name, level, fn,
                                      d or f"(undocumented {level} pass)",
                                      patterns if callable(patterns)
                                      else tuple(patterns))
        return fn
    return deco


def suggest_pass(name: str) -> Optional[str]:
    """Closest registered pass/alias name, for did-you-mean diagnostics."""
    universe = sorted(set(PASS_REGISTRY) | set(PASS_ALIASES))
    close = difflib.get_close_matches(name, universe, n=1, cutoff=0.5)
    return close[0] if close else None


def resolve_pass(name: str) -> PassDef:
    pd = PASS_REGISTRY.get(PASS_ALIASES.get(name, name))
    if pd is None:
        sugg = suggest_pass(name)
        hint = f"did you mean {sugg!r}? " if sugg else ""
        raise KeyError(f"unknown pass {name!r}; {hint}"
                       f"registered: {sorted(PASS_REGISTRY)}")
    return pd


# ---- built-in passes --------------------------------------------------------


@register_pass("lower", "tensor", "TensorIR -> LoopIR (nested sequential)")
def _lower(g: Graph, tile_m: int = 1, tile_n: int = 1, tile_k: int = 1,
           use_accumulator: int = 1) -> Kernel:
    return lowering.lower_graph(g, lowering.LoweringOptions(
        tile_m=tile_m, tile_n=tile_n, tile_k=tile_k,
        use_accumulator=bool(use_accumulator)))


@register_pass("flatten-inner", "loop", "paper's inner-loop flattening",
               patterns=("set-loop-kind",))
def _flatten(k: Kernel) -> Kernel:
    return schedule.flatten_inner(k)


@register_pass("unroll", "loop", "unroll a named loop",
               patterns=("set-loop-kind",))
def _unroll(k: Kernel, var: str) -> Kernel:
    return schedule.unroll(k, var)


@register_pass("vectorize", "loop", "map a named loop to VPU lanes",
               patterns=("set-loop-kind",))
def _vectorize(k: Kernel, var: str) -> Kernel:
    return schedule.vectorize(k, var)


@register_pass("split", "loop", "split a named loop by a factor",
               patterns=("split-loop",))
def _split(k: Kernel, var: str, factor: int) -> Kernel:
    return schedule.split(k, var, factor)


@register_pass("interchange", "loop", "swap two perfectly nested loops",
               patterns=("interchange-loops",))
def _interchange(k: Kernel, outer: str, inner: str) -> Kernel:
    return schedule.interchange(k, outer, inner)


@register_pass("fuse-epilogue", "loop", "fuse elementwise tail into matmul nest",
               patterns=("fuse-epilogue",))
def _fuse(k: Kernel) -> Kernel:
    return schedule.fuse_epilogue(k)


@register_pass("set-space", "loop",
               "move a scratch buffer between vmem and vreg")
def _set_space(k: Kernel, buffer: str, space: str) -> Kernel:
    try:
        ms = MemSpace(space)
    except ValueError:
        raise ValueError(f"set-space: unknown space {space!r}; choose "
                         f"vmem or vreg")
    if ms == MemSpace.HBM:
        raise ValueError("set-space: scratch buffers cannot move to hbm")
    return schedule.set_space(k, buffer, ms)


@register_pass("grid", "loop", "map the outermost N loops to the pallas grid")
def _grid(k: Kernel, vars: int = 2) -> Kernel:
    count = 0
    stmts = k.body
    while count < vars and len(stmts) >= 1:
        loops = [s for s in stmts if hasattr(s, "kind")]
        if not loops:
            break
        loop = loops[0]
        reason = schedule.carry_axis_reason(loop, LoopKind.GRID)
        if reason:
            raise ValueError(f"grid: {reason}")
        loop.kind = LoopKind.GRID
        count += 1
        stmts = loop.body
    k.verify()
    return k


@register_pass("lower-to-hw", "loop",
               "scheduled LoopIR -> HwIR (FSM + datapath module)")
def _lower_to_hw(k: Kernel, mxu_min_dim: int = 8) -> HwModule:
    return hw_ir.lower_to_hw(k, mxu_min_dim=mxu_min_dim)


@register_pass("emit-verilog", "hw", "emit Verilog-style RTL text")
def _emit_verilog(mod: HwModule) -> str:
    return hw_ir.emit_verilog(mod)


@register_pass("set-sequencer", "hw",
               "re-sequence a loop between @fsm and @stream",
               patterns=("set-sequencer",))
def _set_sequencer(mod: HwModule, counter: str, kind: str) -> HwModule:
    return hw_ir.set_sequencer(mod, counter, kind)


@register_pass("outline-subcircuits", "hw",
               "outline repeated control subtrees into sub-modules",
               patterns=("outline-subcircuits",))
def _outline_subcircuits(mod: HwModule) -> HwModule:
    """Hash the canonical anonymised form of every control subtree and
    outline structural repeats into one sub-module definition + one
    :class:`~repro_torch.core.hw_ir.HwInstance` call state per occurrence, so
    the repeated datapath is declared (and priced) once.  Orphaned unit
    declarations of the outlined occurrences are pruned under
    ``prune-unused-unit``."""
    from . import sharing

    return sharing.outline_subcircuits(mod)


@register_pass("share-units", "hw",
               "time-multiplex datapath units across FSM states")
def _share_units(mod: HwModule, max_copies: int = 0) -> HwModule:
    """Run the port-conflict-aware binding scheduler: same-kind unit
    declarations whose activations sit in different FSM states fold onto
    one shared physical unit via the binding table; ``max_copies`` > 0
    clamps the physical copies, serialising wider virtual users into
    rounds that ``cycles``/``hw_sim`` both price."""
    from . import sharing

    return sharing.share_units(mod, max_copies=max_copies)


@register_pass("set-sharing", "hw",
               "apply a sharing policy: none / share / serialize")
def _set_sharing(mod: HwModule, mode: str = "share") -> HwModule:
    """The DSE's sharing knob: ``none`` keeps the flat form, ``share``
    outlines subcircuits and folds units without serialising, and
    ``serialize`` additionally clamps each shared unit to one physical
    copy, trading serial rounds for the smallest datapath."""
    from . import sharing

    return sharing.set_sharing(mod, mode=mode)


@register_pass("canonicalize", ("tensor", "loop", "hw"),
               "apply the level's canonicalization patterns to a fixpoint",
               patterns=rewrite.canonical_pattern_names)
def _canonicalize(art, max_iterations: int = 32):
    """Drive the artifact level's registered canonicalization pattern
    set (``rewrite.CANONICAL_PATTERNS``) to a fixpoint: TensorIR folds
    identity epilogues and dead ops, LoopIR drops extent-1 loops,
    merges independent adjacent @seq nests and normalizes tile refs,
    HwIR collapses single-trip sequencers, normalizes address
    generators, shares identical datapath units and prunes orphaned
    unit/sub-module declarations.  The one pass registered at all three
    levels; per-pattern hit counts surface on the ``PassRecord``."""
    return rewrite.canonicalize(art, max_iterations=max_iterations)


@register_pass("dse", "tensor",
               "design-space exploration: search schedule programs and "
               "return the Pareto-fastest kernel")
def _dse(g: Graph, validate: int = 0, top: int = 4) -> Kernel:
    """Run :func:`repro_torch.core.dse.explore` over the module and lower the
    winning (feasible, Pareto-fastest) schedule program's loop-level
    pipeline; with ``validate=1`` the ``top`` fastest frontier points
    are co-simulated against the numpy oracle first and the pass FAILS
    if any of them diverges (numerics or modeled cycles).  HwIR-level
    knobs of the winner are dropped (the pass must yield a Kernel so
    the rest of the pipeline can keep lowering); replay the winner's
    full spec through ``reproc`` to keep them."""
    from . import dse

    res = dse.explore(g, validate_top=top if validate else 0)
    bad = [v for v in res.validations if not v.ok]
    if bad:
        raise ValueError(
            f"dse: {len(bad)} frontier point(s) failed co-simulation, "
            f"first: {bad[0].point.spec}: "
            f"{bad[0].detail or f'max|err|={bad[0].max_abs_err:.2e}'}")
    best = res.best()
    if best is None:
        raise ValueError(f"dse: no feasible schedule for {g.name}")
    art = PassManager.parse(best.point.pipeline).run(g).artifact
    return art


@register_pass("simulate", "hw",
               "verification: cycle-accurately execute the module")
def _simulate(mod: HwModule, seed: int = 0, tol_pct: int = 10) -> HwModule:
    """Run the module in ``hw_sim`` on seeded random inputs and fail the
    pipeline if the hardware misbehaves: non-finite outputs, or an
    observed cycle count more than ``tol_pct`` percent away from the
    analytic ``machine_model.cycles`` prediction.  The artifact passes
    through unchanged, so ``...,lower-to-hw,simulate,emit-verilog`` gates
    emission on a clean simulation."""
    from . import hw_sim, machine_model

    try:
        rep = hw_sim.simulate(mod, hw_sim.random_inputs(mod, seed=seed))
    except hw_sim.SimError as e:
        # re-raise on the ValueError channel every pass-failure handler
        # (PassManager -> PassError, reproc diagnostics) listens on
        raise ValueError(f"simulate: {e}") from e
    for name in rep.out_ports:
        if not np.all(np.isfinite(rep.storage[name])):
            raise ValueError(f"simulate: output port {name!r} holds "
                             f"non-finite values")
    modeled = machine_model.cycles(mod).total
    if modeled > 0:
        dev = abs(rep.cycles.total - modeled) / modeled
        if dev > tol_pct / 100.0:
            raise ValueError(
                f"simulate: observed {rep.cycles.total:,} cycles deviates "
                f"{dev:.1%} from modeled {modeled:,} (> {tol_pct}%)")
    return mod


@register_pass("emit-ref", "backend", "emit numpy interpreter callable")
def _emit_ref(k: Kernel):
    return lambda *xs: backend_ref.run(k, xs)


@register_pass("emit-torch", "backend", "emit eager PyTorch callable")
def _emit_torch(k: Kernel, device: str = "cuda"):
    return backend_torch.emit(k, device=device)


@register_pass("emit-cuda", "backend", "emit CUDA kernel (GEMM or per-nest)")
def _emit_cuda(k: Kernel, device: str = "cuda"):
    return backend_cuda.emit(k, device=device)


# ---- pipeline parsing ---------------------------------------------------------

_STAGE_RE = re.compile(r"^([a-zA-Z_][\w\-]*)(?:\{(.*)\})?$")


class PipelineParseError(ValueError):
    """Malformed pipeline spec; the message names the offending offset."""

    def __init__(self, spec: str, offset: int, msg: str):
        super().__init__(f"pipeline spec: {msg} at offset {offset}: "
                         f"{spec!r}")
        self.offset = offset


def parse_pipeline(spec: str) -> List[Dict[str, Any]]:
    """``"lower{tile_m=128},flatten-inner"`` -> [{name, kwargs}, ...].

    Stages separate on ``,`` or ``;`` at brace depth 0 (``;`` matches
    mlir-opt-style specs on the command line, where ``,`` also separates
    pass arguments).  Malformed specs — unbalanced or nested braces,
    stray separators producing empty stages, malformed ``key=value``
    arguments — raise :class:`PipelineParseError` naming the offending
    character offset.
    """
    # ---- lex into (start_offset, text) parts, brace-aware ------------------
    depth = 0
    open_at = -1
    token = ""
    start = 0
    parts: List[Tuple[int, str]] = []
    for off, ch in enumerate(spec):
        if ch == "{":
            if depth:
                raise PipelineParseError(spec, off, "nested '{'")
            depth, open_at = 1, off
        elif ch == "}":
            if not depth:
                raise PipelineParseError(spec, off, "unbalanced '}'")
            depth = 0
        if ch in ",;" and depth == 0:
            if not token.strip():
                raise PipelineParseError(
                    spec, off, f"empty pipeline stage before {ch!r}")
            parts.append((start, token))
            token, start = "", off + 1
        else:
            token += ch
    if depth:
        raise PipelineParseError(spec, open_at, "unclosed '{'")
    if token.strip():
        parts.append((start, token))

    # ---- parse each stage ---------------------------------------------------
    stages = []
    for off, part in parts:
        m = _STAGE_RE.match(part.strip())
        if not m:
            raise PipelineParseError(spec, off,
                                     f"bad pipeline stage {part.strip()!r}")
        name, argstr = m.group(1), m.group(2)
        kwargs: Dict[str, Any] = {}
        if argstr is not None and not argstr.strip():
            raise PipelineParseError(spec, off,
                                     f"empty argument braces on {name!r}")
        if argstr:
            for kv in argstr.split(","):
                key, eq, val = kv.partition("=")
                key, val = key.strip(), val.strip()
                if not key or not eq or not val:
                    raise PipelineParseError(
                        spec, off, f"bad pass argument {kv.strip()!r} on "
                                   f"{name!r} (want key=value)")
                kwargs[key] = int(val) if re.fullmatch(r"-?\d+", val) else val
        stages.append({"name": name, "kwargs": kwargs})
    return stages


# ---- pass manager -----------------------------------------------------------


def _artifact_size(art: Artifact) -> Optional[int]:
    from . import ir_text
    return ir_text.ir_size(art)


def _artifact_text(art: Artifact) -> str:
    from . import ir_text
    if isinstance(art, (Graph, Kernel, HwModule)):
        return ir_text.print_ir(art)
    if isinstance(art, str):                    # emitted RTL text
        return art
    return f"<backend artifact {art!r}>"


@dataclasses.dataclass
class PassRecord:
    """Instrumentation for one executed pass."""

    name: str
    level: str
    kwargs: Dict[str, Any]
    wall_ms: float
    size_before: Optional[int]
    size_after: Optional[int]
    dump_before: Optional[str] = None
    dump_after: Optional[str] = None
    #: per-pattern hit counts from every RewriteDriver the pass ran
    pattern_stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        from . import ir_text

        def sz(v):
            return "-" if v is None else str(v)
        line = (f"{self.name:16s} [{self.level:7s}] {self.wall_ms:8.3f} ms  "
                f"size {sz(self.size_before)} -> {sz(self.size_after)}")
        if self.pattern_stats:
            line += ("  patterns: "
                     + ir_text.format_pattern_stats(self.pattern_stats))
        return line


@dataclasses.dataclass
class PipelineResult:
    artifact: Artifact
    trace: List[str]               # pass-by-pass textual IR dumps
    records: List[PassRecord] = dataclasses.field(default_factory=list)

    def timing_table(self) -> str:
        return "\n".join(r.summary() for r in self.records)


class PassManager:
    """Ordered, level-checked, verified, instrumented pass pipeline.

    Build programmatically (``add``) or from the string syntax
    (``PassManager.parse``); ``spec()`` round-trips back to the string
    form.  ``run`` executes the pipeline on a Graph/Kernel artifact and
    returns a :class:`PipelineResult` whose ``records`` carry per-pass
    wall time, IR-size deltas, and (when dumping) before/after IR text.
    """

    def __init__(self, *, verify: bool = True, dump_after_each: bool = False,
                 dump_before_each: bool = False):
        self.verify = verify
        self.dump_after_each = dump_after_each
        self.dump_before_each = dump_before_each
        self._stages: List[Tuple[PassDef, Dict[str, Any]]] = []

    # ---- construction ------------------------------------------------------

    def add(self, pass_: Union[str, PassDef], **kwargs) -> "PassManager":
        pd = resolve_pass(pass_) if isinstance(pass_, str) else pass_
        self._stages.append((pd, dict(kwargs)))
        return self

    @classmethod
    def parse(cls, spec: str, **opts) -> "PassManager":
        pm = cls(**opts)
        for st in parse_pipeline(spec):
            pm.add(st["name"], **st["kwargs"])
        return pm

    def spec(self) -> str:
        """Serialise back to the pipeline-string syntax.

        Bools serialise as 0/1: the string syntax only knows ints and
        strings, and ``bool("False")`` is True — so ``str(v)`` would not
        survive a parse round-trip.
        """
        parts = []
        for pd, kwargs in self._stages:
            if kwargs:
                kv = ",".join(f"{k}={int(v) if isinstance(v, bool) else v}"
                              for k, v in kwargs.items())
                parts.append(f"{pd.name}{{{kv}}}")
            else:
                parts.append(pd.name)
        return ",".join(parts)

    @property
    def stages(self) -> List[Tuple[PassDef, Dict[str, Any]]]:
        return list(self._stages)

    # ---- execution ---------------------------------------------------------

    @staticmethod
    def _level_type(level: str) -> type:
        if level == "tensor":
            return Graph
        if level == "hw":
            return HwModule
        return Kernel               # "loop" and "backend" consume LoopIR

    def _check_level(self, pd: PassDef, art: Artifact) -> None:
        wants = tuple(dict.fromkeys(self._level_type(lv)
                                    for lv in pd.levels))
        if not isinstance(art, wants):
            have = type(art).__name__
            names = " or ".join(w.__name__ for w in wants)
            raise PassError(
                f"pass {pd.name!r} is a {pd.level_str}-level pass and needs "
                f"a {names}, but the pipeline artifact is {have} — "
                f"check pass ordering (backend passes are terminal)")

    def _verify(self, pd: PassDef, art: Artifact, when: str) -> None:
        if self.verify and isinstance(art, (Graph, Kernel, HwModule)):
            try:
                art.verify()
            except ValueError as e:
                raise PassError(f"IR verification failed {when} pass "
                                f"{pd.name!r}: {e}") from e

    def run(self, artifact: Artifact) -> PipelineResult:
        art = artifact
        trace: List[str] = []
        records: List[PassRecord] = []
        # textual dumps (trace + PassRecord.dump_*) are only rendered when a
        # dump flag is set: printing the IR after every pass is O(IR size)
        # and run() sits on the compile hot path (autotune sweeps it).
        keep_trace = self.dump_after_each or self.dump_before_each
        if isinstance(art, (Graph, Kernel, HwModule)) and self.verify:
            try:
                art.verify()
            except ValueError as e:
                raise PassError(f"input IR failed verification: {e}") from e
        if keep_trace:
            trace.append(f"== input ==\n{_artifact_text(art)}"
                         if isinstance(art, (Graph, Kernel, HwModule)) else "== input ==")
        for pd, kwargs in self._stages:
            self._check_level(pd, art)
            # multi-level passes record the level they actually ran at
            level = (pd.level if isinstance(pd.level, str)
                     else rewrite.level_of(art))
            size_before = _artifact_size(art)
            dump_before = (_artifact_text(art)
                           if self.dump_before_each else None)
            t0 = time.perf_counter()
            try:
                with rewrite.collect_stats() as pattern_stats:
                    art = pd.fn(art, **kwargs)
            except PassError:
                raise
            except (ValueError, KeyError, TypeError) as e:
                raise PassError(f"pass {pd.name!r} failed: {e}") from e
            wall_ms = (time.perf_counter() - t0) * 1e3
            self._verify(pd, art, "after")
            dump_after = (_artifact_text(art)
                          if self.dump_after_each else None)
            records.append(PassRecord(
                name=pd.name, level=level, kwargs=dict(kwargs),
                wall_ms=wall_ms, size_before=size_before,
                size_after=_artifact_size(art),
                dump_before=dump_before, dump_after=dump_after,
                pattern_stats=pattern_stats))
            if self.dump_after_each:
                if isinstance(art, (Graph, Kernel, HwModule)):
                    trace.append(f"== after {pd.name} ==\n{dump_after}")
                else:
                    trace.append(f"== after {pd.name} == <{pd.level} artifact>")
        return PipelineResult(art, trace, records)


def run_pipeline(graph: Artifact, spec: str, dump: bool = False) -> PipelineResult:
    """The paper's "script": run a declared pass pipeline end to end with
    verification between stages.  Thin wrapper over :class:`PassManager`
    kept for the original seed API (``PipelineResult.trace`` only carries
    dumps when ``dump=True``)."""
    pm = PassManager.parse(spec, dump_after_each=dump)
    return pm.run(graph)
