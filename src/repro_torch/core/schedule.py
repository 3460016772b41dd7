"""Scheduling passes on LoopIR — the paper's optimization layer.

The paper's single studied transformation is *inner-for-loop flattening*
(unrolling the innermost loop so the datapath is replicated spatially
instead of time-multiplexed).  ``flatten_inner`` below is exactly that
pass.  Around it we provide the passes a reusable scheduling layer needs
on TPU: loop splitting, interchange, grid-parallelisation (pallas grid),
vectorisation, and memory-space placement.

Every structural transform here is a :class:`~repro_torch.core.rewrite.Pattern`
applied by the shared :class:`~repro_torch.core.rewrite.RewriteDriver` — the
module no longer hand-rolls its own traversal/reconstruction.  The
public pass functions keep their pre-refactor signatures, in-place
semantics, and diagnostics; they construct the pattern, run the driver,
and re-verify, mirroring MLIR's pass + verifier discipline.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import rewrite
from .loop_ir import (AffineExpr, Buffer, EwiseTile, FillTile, Kernel, Loop,
                      LoopKind, LoopVar, MatmulTile, MemSpace, ReduceTile,
                      ScanTile, Stmt, TileRef, ZeroTile)
from .rewrite import OneShotPattern, RewriteDriver, RewriteError


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _rewrite_refs(stmts: List[Stmt], fn) -> None:
    rewrite._map_stmt_refs(stmts, fn)


def _body_stmts(stmts):
    for s in stmts:
        yield s
        if isinstance(s, Loop):
            yield from _body_stmts(s.body)


def carry_axis_reason(loop: Loop, kind: LoopKind) -> Optional[str]:
    """Why re-annotating ``loop`` as ``kind`` would break a carried
    reduction/scan in its body — ``None`` when legal.

    Spatial kinds (@grid/@vector) replicate the loop's datapath, so a
    loop that *iterates a carry* (the running max/sum of an online
    softmax, the state of an SSD scan) cannot take them: each replica
    would see only its own slice of the recurrence.  SEQUENTIAL and
    UNROLLED preserve program order and stay legal, as does splitting
    the axis (both halves remain sequential).  ``MatmulTile``
    k-accumulation is exempt — the pallas backend threads that carry
    with a revisit-aware ``pl.when`` init.
    """
    if kind not in (LoopKind.GRID, LoopKind.VECTOR):
        return None
    v = loop.var.name
    # accumulators (re)initialised inside the body are confined to one
    # iteration — only a carry that *crosses* iterations of this loop
    # (its init lives outside) makes the spatial kind illegal
    inits = {s.dst.buffer.name for s in _body_stmts(loop.body)
             if isinstance(s, (FillTile, ZeroTile))}
    for s in _body_stmts(loop.body):
        if isinstance(s, ReduceTile) and s.accumulate and \
                s.dst.buffer.name not in inits and \
                not any(var == v for e in s.dst.index for var, _ in e.coeffs):
            return (f"loop %{v} iterates the carried reduction axis of "
                    f"reduce<{s.kind}> into {s.dst.buffer.name}: "
                    f"@{kind.value} would replicate the running statistic "
                    f"spatially without threading the carry (keep it @seq, "
                    f"unroll it, or split it)")
        if isinstance(s, ScanTile) and \
                any(var == v for var, _ in s.dst.index[0].coeffs):
            return (f"loop %{v} iterates the scan axis of scan<{s.kind}> "
                    f"into {s.dst.buffer.name}: the carry threads "
                    f"sequentially, so @{kind.value} on the time axis "
                    f"would miscompile (keep it @seq, unroll it, or "
                    f"split it)")
    return None


def _run_one_shot(kernel: Kernel, pat: OneShotPattern,
                  missing: str) -> Kernel:
    """Drive a one-shot pattern over ``kernel`` (in place); raise
    ``KeyError(missing)`` if its target never matched."""
    RewriteDriver([pat], max_iterations=2).run(kernel)
    if not pat.applied:
        raise KeyError(missing)
    kernel.verify()
    return kernel


# --------------------------------------------------------------------------
# patterns (the ported transforms)
# --------------------------------------------------------------------------


class SetLoopKind(OneShotPattern):
    """Re-annotate the named loop with a new ``LoopKind``."""

    name = "set-loop-kind"

    def __init__(self, var: str, kind: LoopKind):
        super().__init__()
        self.var = var
        self.kind = kind

    def apply_once(self, parent, siblings, i, root):
        loop = siblings[i]
        if not isinstance(loop, Loop) or loop.var.name != self.var:
            return None
        reason = carry_axis_reason(loop, self.kind)
        if reason:
            raise RewriteError(f"set-loop-kind: {reason}")
        loop.kind = self.kind
        return (1, [loop])


class SplitLoop(OneShotPattern):
    """var(E) -> var_o(E/factor) x var_i(factor); rewrites affine indices."""

    name = "split-loop"

    def __init__(self, var: str, factor: int):
        super().__init__()
        self.var = var
        self.factor = factor

    def apply_once(self, parent, siblings, i, root):
        loop = siblings[i]
        if not isinstance(loop, Loop) or loop.var.name != self.var:
            return None
        E, var, factor = loop.var.extent, self.var, self.factor
        if E % factor:
            raise RewriteError(
                f"split: {factor} does not divide extent {E} of {var}")
        vo = LoopVar(var + "_o", E // factor)
        vi = LoopVar(var + "_i", factor)

        def rw(ref: TileRef) -> TileRef:
            new_idx = []
            for e in ref.index:
                coeffs = []
                for v, s in e.coeffs:
                    if v == var:
                        coeffs.append((vo.name, s * factor))
                        coeffs.append((vi.name, s))
                    else:
                        coeffs.append((v, s))
                new_idx.append(AffineExpr(tuple(coeffs), e.const))
            return TileRef(ref.buffer, tuple(new_idx), ref.tile)

        _rewrite_refs(loop.body, rw)
        inner_loop = Loop(vi, loop.kind, loop.body)
        loop.var = vo
        loop.body = [inner_loop]
        return (1, [loop])


class InterchangeLoops(OneShotPattern):
    """Swap two perfectly-nested loops (vars and kinds trade places)."""

    name = "interchange-loops"

    def __init__(self, outer: str, inner: str):
        super().__init__()
        self.outer = outer
        self.inner = inner

    def apply_once(self, parent, siblings, i, root):
        lo = siblings[i]
        if not isinstance(lo, Loop) or lo.var.name != self.outer:
            return None
        if not (len(lo.body) == 1 and isinstance(lo.body[0], Loop)
                and lo.body[0].var.name == self.inner):
            raise RewriteError(
                f"{self.outer} and {self.inner} are not perfectly nested")
        li = lo.body[0]
        lo.var, li.var = li.var, lo.var
        lo.kind, li.kind = li.kind, lo.kind
        return (1, [lo])


# --------------------------------------------------------------------------
# passes
# --------------------------------------------------------------------------


def _not_found(kernel: Kernel, var: str) -> str:
    return f"loop {var!r} not found in kernel {kernel.name}"


def unroll(kernel: Kernel, var: str) -> Kernel:
    """Mark loop ``var`` UNROLLED: spatial replication of its datapath."""
    return _run_one_shot(kernel, SetLoopKind(var, LoopKind.UNROLLED),
                         _not_found(kernel, var))


def vectorize(kernel: Kernel, var: str) -> Kernel:
    return _run_one_shot(kernel, SetLoopKind(var, LoopKind.VECTOR),
                         _not_found(kernel, var))


def parallelize(kernel: Kernel, var: str) -> Kernel:
    """Map loop ``var`` to the pallas grid (must be loop-carried-free)."""
    return _run_one_shot(kernel, SetLoopKind(var, LoopKind.GRID),
                         _not_found(kernel, var))


def flatten_inner(kernel: Kernel) -> Kernel:
    """The paper's transformation: fully unroll the innermost loop of the
    deepest nest (TABLE I: "Inner Flattened for-loop")."""
    deepest: Optional[Loop] = None
    depth_of = -1
    for s, depth, _ in kernel.walk():
        if isinstance(s, Loop) and not any(isinstance(b, Loop) for b in s.body):
            if depth > depth_of:
                depth_of, deepest = depth, s
    if deepest is None:
        raise ValueError(f"kernel {kernel.name} has no innermost loop")
    return _run_one_shot(kernel,
                         SetLoopKind(deepest.var.name, LoopKind.UNROLLED),
                         _not_found(kernel, deepest.var.name))


def interchange(kernel: Kernel, outer: str, inner: str) -> Kernel:
    """Swap two perfectly-nested loops."""
    return _run_one_shot(kernel, InterchangeLoops(outer, inner),
                         _not_found(kernel, outer))


def split(kernel: Kernel, var: str, factor: int) -> Kernel:
    """var(E) -> var_o(E/factor) x var_i(factor); rewrites affine indices."""
    return _run_one_shot(kernel, SplitLoop(var, factor),
                         _not_found(kernel, var))


def set_space(kernel: Kernel, buffer_name: str, space: MemSpace) -> Kernel:
    """Move a scratch buffer between VMEM and VREG (HBM params are fixed)."""
    for i, b in enumerate(kernel.scratch):
        if b.name == buffer_name:
            nb = Buffer(b.name, b.type, space)
            kernel.scratch[i] = nb

            def rw(ref: TileRef) -> TileRef:
                if ref.buffer.name == buffer_name:
                    return TileRef(nb, ref.index, ref.tile)
                return ref

            _rewrite_refs(kernel.body, rw)
            kernel.verify()
            return kernel
    raise KeyError(f"scratch buffer {buffer_name!r} not found")


class FuseEpiloguePattern(rewrite.Pattern):
    """Fuse an adjacent elementwise nest that consumes a matmul's output
    tile-for-tile into the producer nest (removes an HBM round-trip)."""

    name = "fuse-epilogue"

    def match_and_rewrite(self, parent, siblings, i, root):
        # only top-level nests fuse (the canonical matmul -> ewise chain
        # produced by lowering.py sits directly in the kernel body)
        if not isinstance(parent, Kernel) or i + 1 >= len(siblings):
            return None
        a, b = siblings[i], siblings[i + 1]
        if not (isinstance(a, Loop) and isinstance(b, Loop)):
            return None
        prods = _stored_hbm_buffers(a)
        if not prods:
            return None
        cons_srcs = _loopnest_leaf(b)
        if cons_srcs is None:
            return None
        leaf_stmts, b_vars = cons_srcs
        if len(leaf_stmts) != 1 or not isinstance(leaf_stmts[0], EwiseTile):
            return None
        ew = leaf_stmts[0]
        hits = [p for p in prods if any(r.buffer.name == p for r in ew.srcs)]
        if not hits:
            return None
        prod = hits[0]
        a_vars = _nest_vars(a)
        if len(a_vars) < len(b_vars):
            return None
        # the consumer must walk the *same tile grid* as the producer's
        # outer loops: equal extents, and its refs use matching tiles.
        if any(av.extent != bv.extent for av, bv in zip(a_vars, b_vars)):
            return None
        prod_tile = _store_tile(a, prod)
        if prod_tile is not None and ew.dst.tile[-len(prod_tile):] != prod_tile:
            return None
        # the fused stmt lands at the END of the loop at depth
        # len(b_vars), so the producer's store of `prod` must happen
        # inside that loop (a matmul accumulates its HBM dst there).  A
        # carried reduce stores its result via a copy from the
        # accumulator *outside* the inner loop — fusing would read the
        # stale pre-reduction tile, so keep the separate nest.
        target = a
        d = 1
        while d < len(b_vars):
            nxt = [s for s in target.body if isinstance(s, Loop)]
            if not nxt:
                break
            target = nxt[0]
            d += 1
        if _store_tile(target, prod) is None:
            return None
        # substitute the consumer's loop vars by the producer's outer vars
        mapping = dict(zip([v.name for v in b_vars],
                           [v.name for v in a_vars]))

        def rw(ref: TileRef) -> TileRef:
            idx = tuple(AffineExpr(tuple((mapping.get(v, v), s)
                                         for v, s in e.coeffs), e.const)
                        for e in ref.index)
            return TileRef(ref.buffer, idx, ref.tile)

        new_leaf = EwiseTile(ew.op, rw(ew.dst), [rw(r) for r in ew.srcs])
        _append_to_innermost(a, new_leaf, depth=len(b_vars))
        return (2, [a])


def fuse_epilogue(kernel: Kernel) -> Kernel:
    """Fuse a following elementwise loop nest that consumes a matmul's
    output tile-for-tile into the matmul nest (removes an HBM round-trip).

    Handles the canonical ``matmul -> ewise(C, ...)`` chain produced by
    ``lowering.py`` when both nests walk the same tile grid — chained
    epilogues (bias_add then relu) fuse one per driver sweep until the
    fixpoint.  This is the TPU equivalent of keeping the epilogue on the
    accelerator fabric instead of bouncing through the AXI bus.
    """
    RewriteDriver([FuseEpiloguePattern()]).run(kernel)
    kernel.verify()
    return kernel


def _store_tile(loop: Loop, buffer_name: str) -> Optional[Tuple[int, ...]]:
    """Tile shape with which ``buffer_name`` is stored inside the nest."""
    found: List[Tuple[int, ...]] = []

    def go(stmts):
        for s in stmts:
            if isinstance(s, Loop):
                go(s.body)
            elif isinstance(s, (EwiseTile, MatmulTile, ZeroTile)):
                if s.dst.buffer.name == buffer_name:
                    found.append(s.dst.tile)

    go([loop])
    return found[0] if found else None


def _stored_hbm_buffers(loop: Loop) -> List[str]:
    stores: List[str] = []
    def go(stmts):
        for s in stmts:
            if isinstance(s, Loop):
                go(s.body)
            elif isinstance(s, (EwiseTile, MatmulTile, ZeroTile)):
                dst = s.dst
                if dst.buffer.space == MemSpace.HBM and dst.buffer.name not in stores:
                    stores.append(dst.buffer.name)
    go([loop])
    return stores


def _loopnest_leaf(loop: Loop):
    vars_ = []
    cur: Stmt = loop
    while isinstance(cur, Loop):
        vars_.append(cur.var)
        if len(cur.body) != 1:
            return None
        cur = cur.body[0]
    return [cur], vars_


def _nest_vars(loop: Loop) -> List[LoopVar]:
    vars_ = []
    cur: Stmt = loop
    while isinstance(cur, Loop):
        vars_.append(cur.var)
        nested = [s for s in cur.body if isinstance(s, Loop)]
        if len(nested) != 1:
            break
        cur = nested[0]
    return vars_


def _append_to_innermost(loop: Loop, stmt: Stmt, depth: int) -> None:
    cur = loop
    d = 1
    while d < depth:
        nxt = [s for s in cur.body if isinstance(s, Loop)]
        if not nxt:
            break
        cur = nxt[0]
        d += 1
    cur.body.append(stmt)


# --------------------------------------------------------------------------
# canned schedules for the GEMM case study
# --------------------------------------------------------------------------


def schedule_nested(kernel: Kernel) -> Kernel:
    """Paper baseline: leave every loop SEQUENTIAL (time-multiplexed)."""
    return kernel


def schedule_inner_flattened(kernel: Kernel) -> Kernel:
    """Paper optimisation: flatten (fully unroll) the innermost loop."""
    return flatten_inner(kernel)


def schedule_tpu_mxu(kernel: Kernel) -> Kernel:
    """Beyond-paper TPU-native schedule: outer tiles on the pallas grid,
    K-accumulation sequential in VREG (time-multiplexing the MXU — the
    *good* kind of datapath reuse)."""
    loops = kernel.loops()
    # lowering emits i, j, k nests per matmul; grid-map the first two levels
    # (carry-iterating loops stay sequential: the running softmax/scan
    # state cannot be replicated across grid steps)
    tops = [s for s in kernel.body if isinstance(s, Loop)]
    for top in tops:
        if carry_axis_reason(top, LoopKind.GRID) is None:
            top.kind = LoopKind.GRID
        inner = [s for s in top.body if isinstance(s, Loop)]
        if inner and carry_axis_reason(inner[0], LoopKind.GRID) is None:
            inner[0].kind = LoopKind.GRID
    kernel.verify()
    return kernel
