"""Unified pattern-rewrite core — one walk/rewrite/canonicalize
infrastructure shared by all three IR levels.

This is the MLIR greedy-pattern-rewrite analogue the paper's
"reusable and extensible" claim ultimately rests on: instead of every
transform hand-rolling its own traversal, reconstruction and legality
checks (the pre-refactor state: TensorIR passes, LoopIR schedule
transforms and HwIR tree surgery each walked their IR differently),
every level plugs into one driver through a small structural protocol:

  * ``node.children()``      — the node's *mutable* child list (ops of a
    ``Graph``, body of a ``Kernel``/``Loop``, ctrl of an ``HwModule``,
    body of an ``HwLoop``; leaves return ``[]``).  The driver splices
    replacements into this list in place, so artifact identity is
    preserved (passes stay in-place, like the pre-refactor transforms);
  * ``node.rebuild(children)`` — a same-type copy with a new child list
    (the functional counterpart, used by patterns building replacements
    and by anything that wants a structural copy);
  * ``node.is_equivalent(other)`` — structural equivalence via the
    canonical textual form of ``ir_text`` (two nodes are equivalent iff
    they print identically).

On top of the protocol:

  * :class:`Pattern` — match-and-rewrite at one position of a sibling
    list, MLIR-style: return ``None`` when the IR is already in the
    target form (this is what makes fixpoints terminate), otherwise a
    ``(consumed, replacement)`` pair.  ``benefit`` orders competing
    patterns (higher first);
  * :class:`RewriteDriver` — greedy fixpoint application: sweep the
    tree post-order, apply the highest-benefit matching pattern at each
    position, repeat until a full sweep changes nothing or the
    iteration cap trips.  Per-pattern hit counts land in a
    :class:`RewriteStats` and in any active ``collect_stats`` scope —
    the :class:`~repro_torch.core.passes.PassManager` opens one around every
    pass, so pattern statistics surface on ``PassRecord``;
  * a per-level **canonicalization pattern registry**
    (``register_canonical_pattern``) feeding the ``canonicalize`` pass,
    which is registered at tensor, loop AND hw level — the first truly
    level-agnostic pass of the stack.

The LoopIR scheduling passes (``split``/``interchange``/``unroll``/
``vectorize``/``fuse-epilogue`` in ``schedule.py``) and the HwIR
``set-sequencer`` knob are ported onto this driver; see those modules
for the pattern classes.  ``docs/REWRITE.md`` (generated) documents the
registered canonicalization pattern sets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .hw_ir import HwLoop, HwModule, HwStep
from .loop_ir import (AffineExpr, EwiseTile, FillTile, Kernel, Loop,
                      MatmulTile, ReduceTile, ScanTile, Stmt, TileRef,
                      ZeroTile, _stmt_refs, _stmt_written_refs)
from .tensor_ir import Graph, Op


class RewriteError(ValueError):
    """A pattern matched IR it cannot legally rewrite."""


# --------------------------------------------------------------------------
# patterns
# --------------------------------------------------------------------------


#: a pattern's answer: how many siblings it consumed and what replaces them
Replacement = Tuple[int, List[object]]


class Pattern:
    """One rewrite rule.

    Subclasses set ``name`` (kebab-case; defaults to a kebab-cased class
    name) and implement :meth:`match_and_rewrite`.  ``benefit`` breaks
    ties between patterns matching the same position: higher applies
    first (MLIR's ``PatternBenefit``).

    The contract mirrors MLIR's ``matchAndRewrite``: return ``None``
    when the node is *already in the target form* — a pattern that
    keeps reporting a rewrite on its own output livelocks the driver
    into the iteration cap.  In-place mutation of the matched nodes is
    allowed (all three IRs are mutable dataclasses); the returned
    replacement list is spliced over the consumed slice either way.
    """

    benefit: int = 1
    name: str = ""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if not cls.__dict__.get("name"):
            n = cls.__name__.lstrip("_")
            cls.name = "".join("-" + c.lower() if c.isupper() else c
                               for c in n).lstrip("-")

    def match_and_rewrite(self, parent, siblings: List, i: int,
                          root) -> Optional[Replacement]:
        """Try to rewrite ``siblings[i]`` (child list of ``parent``).

        ``root`` is the artifact the driver was started on (patterns
        needing global context — SSA uses, symbol tables — reach it
        here).  Return ``None`` for no match, else ``(consumed,
        replacement)`` where ``consumed >= 1`` nodes starting at ``i``
        are replaced by the ``replacement`` list.
        """
        raise NotImplementedError

    def describe(self) -> str:
        """First docstring paragraph, collapsed to one line (used by the
        generated pattern reference in docs/REWRITE.md)."""
        doc = (self.__doc__ or type(self).__doc__ or "").strip()
        first = doc.split("\n\n", 1)[0]
        return " ".join(ln.strip() for ln in first.splitlines())


class OneShotPattern(Pattern):
    """A directed (parameterised) transform that applies exactly once.

    The ported scheduling passes (``split``, ``interchange``,
    ``set-sequencer``, ...) are one-shots: they name their target, fire
    on it a single time, and the wrapper pass raises if the target was
    never found (``applied`` stays False).  An ineligible target raises
    :class:`RewriteError` from inside the match, preserving the
    pre-refactor diagnostics.
    """

    def __init__(self):
        self.applied = False

    def match_and_rewrite(self, parent, siblings, i, root):
        if self.applied:
            return None
        res = self.apply_once(parent, siblings, i, root)
        if res is not None:
            self.applied = True
        return res

    def apply_once(self, parent, siblings, i, root):
        raise NotImplementedError


class SetSequencer(OneShotPattern):
    """Re-sequence the named HwIR loop between @fsm and @stream."""

    name = "set-sequencer"

    def __init__(self, counter: str, kind: str):
        super().__init__()
        self.counter = counter
        self.kind = kind

    def apply_once(self, parent, siblings, i, root):
        loop = siblings[i]
        if not isinstance(loop, HwLoop) or loop.counter != self.counter:
            return None
        if loop.kind not in ("fsm", "stream"):
            raise RewriteError(
                f"set-sequencer: loop %{self.counter} is @{loop.kind} "
                f"(spatial), not a temporal sequencer")
        loop.kind = self.kind
        return (1, [loop])


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RewriteStats:
    """Outcome of one driver run: per-pattern hit counts + convergence."""

    hits: Dict[str, int] = dataclasses.field(default_factory=dict)
    iterations: int = 0
    converged: bool = True

    @property
    def total(self) -> int:
        return sum(self.hits.values())

    def count(self, pattern_name: str, n: int = 1) -> None:
        self.hits[pattern_name] = self.hits.get(pattern_name, 0) + n

    def __str__(self):
        from . import ir_text
        body = ir_text.format_pattern_stats(self.hits) or "no hits"
        tail = "" if self.converged else " (iteration cap hit!)"
        return f"{body} in {self.iterations} sweep(s){tail}"


#: active ``collect_stats`` scopes (per thread — the DSE prices design
#: points on a thread pool and each thread's pipelines must not leak
#: statistics into another's records); driver runs merge into all scopes
#: of their own thread
_TLS = threading.local()


def _collectors() -> List[Dict[str, int]]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextlib.contextmanager
def collect_stats():
    """Collect per-pattern hit counts from every driver run in scope.

    The PassManager wraps each pass invocation in one of these so
    pattern statistics surface on the pass's ``PassRecord`` regardless
    of how many drivers the pass ran internally.
    """
    acc: Dict[str, int] = {}
    stack = _collectors()
    stack.append(acc)
    try:
        yield acc
    finally:
        # identity-based removal: two scopes with no hits yet are equal
        # ({} == {}), so list.remove would pop the wrong one
        for idx in range(len(stack) - 1, -1, -1):
            if stack[idx] is acc:
                del stack[idx]
                break


def _publish(stats: RewriteStats) -> None:
    for acc in _collectors():
        for k, v in stats.hits.items():
            acc[k] = acc.get(k, 0) + v


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------


class RewriteDriver:
    """Greedy fixpoint pattern application over the structural protocol.

    Sweeps the tree post-order (children before parents, so collapsed
    inner structure is visible to outer matches within one sweep),
    applying the highest-benefit matching pattern at each sibling
    position and re-trying the same position after a hit (a replacement
    may immediately enable another pattern).  Sweeps repeat until one
    changes nothing (``converged``) or ``max_iterations`` trips.
    """

    def __init__(self, patterns: Sequence[Pattern],
                 max_iterations: int = 32):
        if max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        # stable sort: declaration order breaks benefit ties
        self.patterns = sorted(patterns, key=lambda p: -p.benefit)
        self.max_iterations = max_iterations

    def run(self, root) -> RewriteStats:
        stats = RewriteStats()
        changed = True
        while changed and stats.iterations < self.max_iterations:
            stats.iterations += 1
            changed = self._sweep(root, stats)
        stats.converged = not changed
        _publish(stats)
        return stats

    # one full post-order sweep; True if any pattern fired
    def _sweep(self, root, stats: RewriteStats) -> bool:
        changed = False

        def visit(node) -> None:
            nonlocal changed
            kids = node.children()
            i = 0
            while i < len(kids):
                visit(kids[i])
                i += 1
            i = 0
            while i < len(kids):
                for p in self.patterns:
                    res = p.match_and_rewrite(node, kids, i, root)
                    if res is None:
                        continue
                    consumed, repl = res
                    if consumed < 1 or i + consumed > len(kids):
                        raise RewriteError(
                            f"pattern {p.name} returned a bad consumed "
                            f"count {consumed} at position {i}")
                    kids[i:i + consumed] = repl
                    stats.count(p.name)
                    changed = True
                    break
                # always advance: a replacement that enables another match
                # (at this or an earlier position) is picked up by the next
                # sweep — retrying in place would let a misbehaving pattern
                # livelock inside one sweep, out of the iteration cap's reach
                i += 1

        visit(root)
        return changed


# --------------------------------------------------------------------------
# affine normalization (shared by LoopIR tile refs and HwIR address
# generators — the two spellings of the same block-index addressing)
# --------------------------------------------------------------------------


def normalize_affine(e: AffineExpr) -> AffineExpr:
    """Canonical affine form: duplicate variable terms merged, zero
    coefficients dropped, terms sorted by variable name."""
    merged: Dict[str, int] = {}
    for v, s in e.coeffs:
        merged[v] = merged.get(v, 0) + s
    coeffs = tuple(sorted((v, s) for v, s in merged.items() if s != 0))
    return AffineExpr(coeffs, e.const)


def _affine_is_normal(e: AffineExpr) -> bool:
    return e.coeffs == normalize_affine(e).coeffs


def _normalize_tileref(r: TileRef) -> TileRef:
    return TileRef(r.buffer, tuple(normalize_affine(e) for e in r.index),
                   r.tile)


# --------------------------------------------------------------------------
# canonicalization pattern registry
# --------------------------------------------------------------------------


#: per-level canonicalization pattern sets feeding the ``canonicalize``
#: pass; extend from outside the core with ``register_canonical_pattern``
CANONICAL_PATTERNS: Dict[str, List[Pattern]] = {
    "tensor": [], "loop": [], "hw": [],
}


def register_canonical_pattern(level: str):
    """Class decorator: instantiate ``cls`` into the ``level`` canonical
    set (the ``register_op``/``register_pass`` analogue for patterns)."""
    if level not in CANONICAL_PATTERNS:
        raise ValueError(f"no canonicalization set for level {level!r}; "
                         f"choose from {sorted(CANONICAL_PATTERNS)}")

    def deco(cls):
        CANONICAL_PATTERNS[level].append(cls())
        return cls
    return deco


def canonical_pattern_names() -> Tuple[str, ...]:
    """``level:name`` for every registered canonicalization pattern."""
    return tuple(f"{lvl}:{p.name}" for lvl in ("tensor", "loop", "hw")
                 for p in CANONICAL_PATTERNS[lvl])


# ---- TensorIR canonicalization ---------------------------------------------


def replace_value_uses(g: Graph, old, new) -> None:
    for op in g.ops:
        op.inputs = [new if v is old else v for v in op.inputs]
    g.outputs = [new if v is old else v for v in g.outputs]


def _use_count(g: Graph, val) -> int:
    n = sum(1 for op in g.ops for v in op.inputs if v is val)
    return n + sum(1 for v in g.outputs if v is val)


@register_canonical_pattern("tensor")
class DeadOpElim(Pattern):
    """Remove ops whose result is never used and is not an output."""

    name = "dead-op-elim"
    benefit = 2

    def match_and_rewrite(self, parent, siblings, i, root):
        op = siblings[i]
        if not isinstance(op, Op) or not isinstance(root, Graph):
            return None
        if _use_count(root, op.result):
            return None
        return (1, [])


@register_canonical_pattern("tensor")
class FoldIdentityCast(Pattern):
    """Fold ``cast`` to the operand's own dtype (an identity epilogue)."""

    name = "fold-identity-cast"

    def match_and_rewrite(self, parent, siblings, i, root):
        op = siblings[i]
        if not isinstance(op, Op) or op.opname != "cast":
            return None
        src = op.inputs[0]
        if op.attrs.get("dtype") != src.type.dtype:
            return None
        replace_value_uses(root, op.result, src)
        return (1, [])


@register_canonical_pattern("tensor")
class FoldIdentityTranspose(Pattern):
    """Fold ``transpose`` with the identity permutation."""

    name = "fold-identity-transpose"

    def match_and_rewrite(self, parent, siblings, i, root):
        op = siblings[i]
        if not isinstance(op, Op) or op.opname != "transpose":
            return None
        perm = list(op.attrs.get("perm", ()))
        if perm != list(range(len(perm))) or not perm:
            return None
        replace_value_uses(root, op.result, op.inputs[0])
        return (1, [])


@register_canonical_pattern("tensor")
class FoldIdempotentEwise(Pattern):
    """Fold ``f(f(x))`` for idempotent elementwise ops (``relu``)."""

    name = "fold-idempotent-ewise"
    _IDEMPOTENT = ("relu",)

    def match_and_rewrite(self, parent, siblings, i, root):
        op = siblings[i]
        if not isinstance(op, Op) or op.opname not in self._IDEMPOTENT:
            return None
        prod = op.inputs[0].producer
        if prod is None or prod.opname != op.opname:
            return None
        replace_value_uses(root, op.result, op.inputs[0])
        return (1, [])


# ---- LoopIR canonicalization -----------------------------------------------


def _subst_zero(stmts: Sequence[Stmt], var: str) -> None:
    """Substitute loop variable ``var`` := 0 in every tile ref under
    ``stmts`` (in place): its affine terms simply drop."""

    def fix(ref: TileRef) -> TileRef:
        idx = tuple(AffineExpr(tuple((v, s) for v, s in e.coeffs
                                     if v != var), e.const)
                    for e in ref.index)
        return TileRef(ref.buffer, idx, ref.tile)

    _map_stmt_refs(stmts, fix)


def _map_stmt_refs(stmts: Sequence[Stmt], fn) -> None:
    for s in stmts:
        if isinstance(s, Loop):
            _map_stmt_refs(s.body, fn)
        elif isinstance(s, ZeroTile):
            s.dst = fn(s.dst)
        elif isinstance(s, MatmulTile):
            s.dst, s.lhs, s.rhs = fn(s.dst), fn(s.lhs), fn(s.rhs)
        elif isinstance(s, EwiseTile):
            s.dst = fn(s.dst)
            s.srcs = [fn(r) for r in s.srcs]
        elif isinstance(s, FillTile):
            s.dst = fn(s.dst)
        elif isinstance(s, ReduceTile):
            s.dst, s.src = fn(s.dst), fn(s.src)
        elif isinstance(s, ScanTile):
            s.dst = fn(s.dst)
            s.srcs = [fn(r) for r in s.srcs]
            s.carry = fn(s.carry)


@register_canonical_pattern("loop")
class DropUnitLoop(Pattern):
    """Inline @seq loops with extent 1 (their variable is constantly 0).
    Annotation-bearing kinds (@grid/@vector/@unrolled) are kept even at
    extent 1: they carry the backend mapping (a @grid loop IS the pallas
    grid), so erasing them would silently change what a kernel can emit
    to.  Their hardware spelling still canonicalizes — trip-1 @stream
    sequencers collapse at the hw level."""

    name = "drop-unit-loop"
    benefit = 2

    def match_and_rewrite(self, parent, siblings, i, root):
        from .loop_ir import LoopKind
        loop = siblings[i]
        if not isinstance(loop, Loop) or loop.var.extent != 1:
            return None
        if loop.kind != LoopKind.SEQUENTIAL:
            return None
        _subst_zero(loop.body, loop.var.name)
        return (1, list(loop.body))


def _buffer_names(stmts: Sequence[Stmt], written: bool) -> set:
    out: set = set()

    def go(ss):
        for s in ss:
            if isinstance(s, Loop):
                go(s.body)
                continue
            refs = _stmt_refs(s)
            if written:
                # _stmt_written_refs: dst, plus the carry for ScanTile
                out.update(r.buffer.name for r in _stmt_written_refs(s))
            else:
                out.update(r.buffer.name for r in refs[1:])
                if isinstance(s, (MatmulTile, ReduceTile)) and s.accumulate:
                    out.add(s.dst.buffer.name)      # read-modify-write
    go(stmts)
    return out


def _loop_var_names(stmts: Sequence[Stmt]) -> set:
    out: set = set()

    def go(ss):
        for s in ss:
            if isinstance(s, Loop):
                out.add(s.var.name)
                go(s.body)
    go(stmts)
    return out


@register_canonical_pattern("loop")
class MergeAdjacentSeqLoops(Pattern):
    """Merge adjacent SEQUENTIAL loops of equal extent whose bodies touch
    disjoint buffers (independent nests: any interleaving is legal)."""

    name = "merge-seq-loops"

    def match_and_rewrite(self, parent, siblings, i, root):
        from .loop_ir import LoopKind
        if i + 1 >= len(siblings):
            return None
        a, b = siblings[i], siblings[i + 1]
        if not (isinstance(a, Loop) and isinstance(b, Loop)):
            return None
        if a.kind != LoopKind.SEQUENTIAL or b.kind != LoopKind.SEQUENTIAL:
            return None
        if a.var.extent != b.var.extent:
            return None
        wa, ra = _buffer_names(a.body, True), _buffer_names(a.body, False)
        wb, rb = _buffer_names(b.body, True), _buffer_names(b.body, False)
        if (wa & (rb | wb)) or (wb & ra):
            return None                     # dependent nests: not our call
        # renaming b's var to a's must not capture a nested loop name
        if a.var.name in _loop_var_names(b.body):
            return None

        def rename(ref: TileRef) -> TileRef:
            idx = tuple(AffineExpr(
                tuple((a.var.name if v == b.var.name else v, s)
                      for v, s in e.coeffs), e.const) for e in ref.index)
            return TileRef(ref.buffer, idx, ref.tile)

        _map_stmt_refs(b.body, rename)
        a.body.extend(b.body)
        return (2, [a])


@register_canonical_pattern("loop")
class NormalizeTileRefs(Pattern):
    """Normalize tile-ref address expressions (merge duplicate terms,
    drop zero coefficients, sort terms by variable)."""

    name = "normalize-tileref"

    def match_and_rewrite(self, parent, siblings, i, root):
        s = siblings[i]
        if isinstance(s, Loop) or not isinstance(s, Stmt):
            return None
        if all(_affine_is_normal(e) for r in _stmt_refs(s) for e in r.index):
            return None
        _map_stmt_refs([s], _normalize_tileref)
        return (1, [s])


# ---- HwIR canonicalization -------------------------------------------------


@register_canonical_pattern("hw")
class CollapseTrip1Sequencer(Pattern):
    """Collapse @fsm/@stream sequencers with a single trip (their counter
    is constantly 0; the header state is pure overhead)."""

    name = "collapse-trip1-sequencer"
    benefit = 2

    def match_and_rewrite(self, parent, siblings, i, root):
        loop = siblings[i]
        if not isinstance(loop, HwLoop) or loop.trips != 1:
            return None
        if loop.kind not in ("fsm", "stream"):
            return None
        for node in _walk_hw(loop.body):
            if isinstance(node, HwStep):
                for o in node.operands:
                    idx = tuple(
                        AffineExpr(tuple((v, s) for v, s in e.coeffs
                                         if v != loop.counter), e.const)
                        for e in o.index)
                    if idx != o.index:
                        object.__setattr__(o, "index", idx)
        return (1, list(loop.body))


def _walk_hw(nodes):
    for n in nodes:
        yield n
        if isinstance(n, HwLoop):
            yield from _walk_hw(n.body)


@register_canonical_pattern("hw")
class NormalizeAddrGen(Pattern):
    """Dedupe identical terms inside operand address generators and sort
    them (the HwIR spelling of tile-ref normalization)."""

    name = "normalize-addr-gen"

    def match_and_rewrite(self, parent, siblings, i, root):
        step = siblings[i]
        if not isinstance(step, HwStep):
            return None
        dirty = False
        for o in step.operands:
            norm = tuple(normalize_affine(e) for e in o.index)
            if norm != o.index:
                object.__setattr__(o, "index", norm)
                dirty = True
        return (1, [step]) if dirty else None


@register_canonical_pattern("hw")
class DedupeUnits(Pattern):
    """Share identical datapath units: steps invoking a unit with the
    same (kind, geometry, copies) as an earlier unit are repointed to
    the first instance; orphaned duplicates are pruned by the
    canonicalize pass."""

    name = "dedupe-units"

    def match_and_rewrite(self, parent, siblings, i, root):
        step = siblings[i]
        if not isinstance(step, HwStep) or not isinstance(root, HwModule):
            return None
        if root.binding_of(step.unit) is not None:
            # the step runs on a shared physical unit through the binding
            # table; repointing it at a bare declaration would silently
            # drop the binding's serialization accounting
            return None
        mine = root.unit(step.unit)
        for u in root.units:
            if u.name == mine.name:
                return None                 # already the first instance
            if (u.kind, u.geometry, u.copies) == \
                    (mine.kind, mine.geometry, mine.copies):
                step.unit = u.name
                return (1, [step])
        return None


def _prune_unused_units(mod: HwModule) -> int:
    """Drop unit declarations no step references (counted in stats under
    ``prune-unused-unit`` — they may predate the canonicalize run).

    Binding-aware: a physical unit is live while any binding row still
    points at it, and a binding row is live while any step references
    its virtual name (dangling rows drop with their virtual).  Recurses
    into sub-module definitions — each owns its own declarations.
    """
    removed = sum(_prune_unused_units(s) for s in mod.submodules)
    used = {s.unit for s in mod.steps()}
    mod.bindings = [b for b in mod.bindings if b.virtual in used]
    keep = used | {b.unit for b in mod.bindings}
    before = len(mod.units)
    mod.units = [u for u in mod.units if u.name in keep]
    return removed + before - len(mod.units)


def _prune_unused_modules(mod: HwModule) -> int:
    """Drop sub-module definitions no instance references (counted under
    ``prune-unused-module`` — rewrites may have orphaned a definition by
    replacing its last call site)."""
    removed = sum(_prune_unused_modules(s) for s in mod.submodules)
    from .hw_ir import HwInstance
    used = {n.module for n, _, _ in mod.walk() if isinstance(n, HwInstance)}
    before = len(mod.submodules)
    mod.submodules = [s for s in mod.submodules if s.name in used]
    return removed + before - len(mod.submodules)


# --------------------------------------------------------------------------
# the canonicalize entry point
# --------------------------------------------------------------------------


def level_of(art) -> str:
    """IR level of an artifact (the dispatch the canonicalize pass uses)."""
    if isinstance(art, Graph):
        return "tensor"
    if isinstance(art, Kernel):
        return "loop"
    if isinstance(art, HwModule):
        return "hw"
    raise TypeError(f"no rewrite level for {type(art).__name__}")


def canonicalize(art, max_iterations: int = 32) -> "art":
    """Drive the artifact's level-specific canonicalization pattern set
    to a fixpoint (in place) and return it.  Idempotent: a second run
    is a no-op — the CI canonicalize-smoke step diffs exactly that."""
    lvl = level_of(art)
    stats = RewriteDriver(CANONICAL_PATTERNS[lvl],
                          max_iterations=max_iterations).run(art)
    if lvl == "hw":
        pruned = _prune_unused_units(art)
        if pruned:
            stats.count("prune-unused-unit", pruned)
            _publish(RewriteStats(hits={"prune-unused-unit": pruned}))
        orphaned = _prune_unused_modules(art)
        if orphaned:
            stats.count("prune-unused-module", orphaned)
            _publish(RewriteStats(hits={"prune-unused-module": orphaned}))
    if not stats.converged:
        raise RewriteError(
            f"canonicalize: no fixpoint after {stats.iterations} sweeps "
            f"on {lvl} artifact ({stats})")
    return art


def canonical_text(art) -> str:
    """Canonical textual form of a *copy* of ``art`` (the artifact is
    re-parsed first so the caller's object is never mutated).  The DSE
    applies this to each design point's lowered HwModule to build its
    dedupe key (:func:`repro_torch.core.dse.canonical_key`)."""
    from . import ir_text
    copy = ir_text.parse_ir(ir_text.print_ir(art))
    return ir_text.print_ir(canonicalize(copy))
