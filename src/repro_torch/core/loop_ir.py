"""LoopIR — level-2 (hardware-shaped) dialect of the stagecc stack.

This plays the role Calyx plays in the paper's pipeline: explicit control
(loop nests with sequential / unrolled / grid-parallel semantics) over
explicit storage (buffers with a memory space: HBM, VMEM, VREG).

LoopIR is *tile-structured*: statements operate on rectangular tiles of
buffers addressed by affine functions of the loop variables.  This matches
the TPU execution model (the MXU consumes 128x128 tiles; the VPU consumes
8x128 vectors) the same way Calyx's cells match FPGA primitives.

The scheduling decisions the paper studies — nested (time-multiplexed)
versus inner-flattened (spatially unrolled) loops — are expressed here as
``LoopKind`` annotations, placed by passes in ``schedule.py`` and consumed
by the cycle/resource models and the three backends.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .tensor_ir import TensorType, dtype_bytes


class MemSpace(enum.Enum):
    HBM = "hbm"      # off-chip: kernel arguments live here
    VMEM = "vmem"    # on-chip scratch (the BRAM analogue)
    VREG = "vreg"    # register tile (the FF/LUT-register analogue)


class LoopKind(enum.Enum):
    SEQUENTIAL = "seq"        # time-multiplexed: one datapath, re-used each iter
    UNROLLED = "unrolled"     # spatially flattened: paper's "inner-flattened"
    GRID = "grid"             # mapped to the pallas grid (outer parallel dim)
    VECTOR = "vector"         # mapped to VPU lanes


@dataclasses.dataclass(frozen=True)
class Buffer:
    name: str
    type: TensorType
    space: MemSpace = MemSpace.HBM

    @property
    def shape(self):
        return self.type.shape

    def __str__(self):
        return f"{self.name}: {self.type} @{self.space.value}"


@dataclasses.dataclass(frozen=True)
class LoopVar:
    name: str
    extent: int

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class AffineExpr:
    """sum_i coeff[var_i] * var_i + const   (strides in *tile* units)."""

    coeffs: Tuple[Tuple[str, int], ...] = ()
    const: int = 0

    @staticmethod
    def of(var: Optional[LoopVar], stride: int = 1, const: int = 0) -> "AffineExpr":
        if var is None:
            return AffineExpr((), const)
        return AffineExpr(((var.name, stride),), const)

    def evaluate(self, env: Dict[str, int]) -> int:
        return self.const + sum(env[v] * s for v, s in self.coeffs)

    def __str__(self):
        from . import ir_text
        return ir_text.print_affine(self)


@dataclasses.dataclass(frozen=True)
class TileRef:
    """A rectangular window of ``buffer``: start = idx * tile, size = tile.

    ``index`` has one AffineExpr per buffer dimension, in units of the tile
    size for that dimension (block-index addressing, exactly like a pallas
    BlockSpec index_map).
    """

    buffer: Buffer
    index: Tuple[AffineExpr, ...]
    tile: Tuple[int, ...]

    def __post_init__(self):
        if len(self.index) != len(self.buffer.shape) or \
           len(self.tile) != len(self.buffer.shape):
            raise ValueError(f"rank mismatch in TileRef on {self.buffer.name}")
        for t, d in zip(self.tile, self.buffer.shape):
            if t <= 0 or t > d:
                raise ValueError(
                    f"tile {self.tile} does not fit buffer {self.buffer}")

    @property
    def tile_elems(self) -> int:
        return int(np.prod(self.tile))

    @property
    def tile_bytes(self) -> int:
        return self.tile_elems * dtype_bytes(self.buffer.type.dtype)

    def slices(self, env: Dict[str, int]) -> Tuple[slice, ...]:
        out = []
        for e, t, d in zip(self.index, self.tile, self.buffer.shape):
            start = e.evaluate(env) * t
            if start < 0 or start + t > d:
                raise IndexError(
                    f"tile [{start}:{start+t}] out of bounds on {self.buffer.name} "
                    f"(dim {d})")
            out.append(slice(start, start + t))
        return tuple(out)

    def __str__(self):
        from . import ir_text
        return ir_text.print_tileref(self)


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Stmt:
    def __str__(self):
        # canonical (parseable) statement text lives in ir_text
        from . import ir_text
        return "\n".join(ir_text.print_stmt(self))

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List["Stmt"]:
        return []

    def rebuild(self, children: Sequence["Stmt"]) -> "Stmt":
        assert not children
        return dataclasses.replace(self)

    def is_equivalent(self, other) -> bool:
        from . import ir_text
        return isinstance(other, Stmt) and \
            ir_text.print_stmt(self) == ir_text.print_stmt(other)


@dataclasses.dataclass
class ZeroTile(Stmt):
    """dst <- 0  (accumulator initialisation)."""

    dst: TileRef


@dataclasses.dataclass
class MatmulTile(Stmt):
    """dst (+)= lhs @ rhs on the MXU.  dst: (m,n), lhs: (m,k), rhs: (k,n)."""

    dst: TileRef
    lhs: TileRef
    rhs: TileRef
    accumulate: bool = True

    def __post_init__(self):
        m, k = self.lhs.tile[-2], self.lhs.tile[-1]
        k2, n = self.rhs.tile[-2], self.rhs.tile[-1]
        m2, n2 = self.dst.tile[-2], self.dst.tile[-1]
        if (m, n) != (m2, n2) or k != k2:
            raise ValueError(
                f"matmul tile mismatch: {self.lhs.tile} @ {self.rhs.tile} "
                f"-> {self.dst.tile}")

    @property
    def macs(self) -> int:
        m, k = self.lhs.tile[-2:]
        n = self.rhs.tile[-1]
        return m * n * k


@dataclasses.dataclass
class EwiseTile(Stmt):
    """dst = op(srcs...) elementwise on the VPU."""

    op: str  # add | mul | sub | maximum | div | relu | gelu | exp | neg
    # | tanh | sigmoid | sqrt | rsqrt | log1p | abs | copy | cast
    dst: TileRef
    srcs: List[TileRef]


@dataclasses.dataclass
class FillTile(Stmt):
    """dst <- value  (carry initialisation to a reduction identity)."""

    dst: TileRef
    value: float = 0.0


@dataclasses.dataclass
class ReduceTile(Stmt):
    """dst (⊕)= reduce(src, last axis, keepdims) on the VPU.

    ``kind`` is ``max`` or ``sum``; with ``accumulate`` the freshly
    reduced tile combines (same ⊕) into ``dst`` — the carried running
    max/sum of online softmax.  ``dst`` tile is ``src`` tile with its
    last dimension collapsed to 1.
    """

    kind: str
    dst: TileRef
    src: TileRef
    accumulate: bool = True

    def __post_init__(self):
        if self.kind not in ("max", "sum"):
            raise ValueError(f"reduce tile: bad kind {self.kind!r}")
        want = self.src.tile[:-1] + (1,)
        if self.dst.tile != want:
            raise ValueError(
                f"reduce tile mismatch: src {self.src.tile} reduces to "
                f"{want}, dst is {self.dst.tile}")


@dataclasses.dataclass
class ScanTile(Stmt):
    """dst <- scan of the tile's rows, threading ``carry`` across tiles.

    ``linear``: h_r = a_r ⊙ h_{r-1} + x_r with h_{-1} read from
    ``carry`` (srcs = [a, x]); ``cumsum`` is the a == 1 case
    (srcs = [x]).  After the tile, ``carry`` holds the last row — the
    inter-tile state of the chunked SSD scan.  ``carry``'s tile is one
    row of ``dst``'s.
    """

    kind: str
    dst: TileRef
    srcs: List[TileRef]
    carry: TileRef

    def __post_init__(self):
        if self.kind not in ("linear", "cumsum"):
            raise ValueError(f"scan tile: bad kind {self.kind!r}")
        if len(self.srcs) != (2 if self.kind == "linear" else 1):
            raise ValueError(
                f"scan<{self.kind}> tile takes "
                f"{2 if self.kind == 'linear' else 1} sources, "
                f"got {len(self.srcs)}")
        want = (1,) + self.dst.tile[1:]
        if self.carry.tile != want:
            raise ValueError(
                f"scan tile carry mismatch: dst {self.dst.tile} carries "
                f"{want}, carry is {self.carry.tile}")
        for s in self.srcs:
            if s.tile != self.dst.tile:
                raise ValueError(
                    f"scan tile mismatch: src {s.tile} vs dst "
                    f"{self.dst.tile}")


@dataclasses.dataclass
class Loop(Stmt):
    var: LoopVar
    kind: LoopKind
    body: List[Stmt]

    def children(self) -> List[Stmt]:
        return self.body

    def rebuild(self, children: Sequence[Stmt]) -> "Loop":
        return Loop(self.var, self.kind, list(children))


@dataclasses.dataclass
class Kernel:
    """A LoopIR function: buffers (params + scratch) and a statement list."""

    name: str
    params: List[Buffer]            # HBM-resident kernel arguments (in order)
    outputs: List[Buffer]           # subset of params that are written
    scratch: List[Buffer]           # VMEM/VREG temporaries
    body: List[Stmt]

    # ---- verification ------------------------------------------------------

    def verify(self) -> None:
        names = [b.name for b in self.params + self.scratch]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate buffer names in kernel {self.name}")
        known = set(names)
        for out in self.outputs:
            if out.name not in {b.name for b in self.params}:
                raise ValueError(f"output {out.name} is not a param")
        for b in self.scratch:
            if b.space == MemSpace.HBM:
                raise ValueError(f"scratch buffer {b.name} cannot live in HBM")

        def check(stmts: Sequence[Stmt], loop_env: Dict[str, int]):
            for s in stmts:
                if isinstance(s, Loop):
                    if s.var.name in loop_env:
                        raise ValueError(f"shadowed loop var {s.var.name}")
                    if s.var.extent <= 0:
                        raise ValueError(f"empty loop {s.var.name}")
                    check(s.body, {**loop_env, s.var.name: s.var.extent})
                else:
                    for ref in _stmt_refs(s):
                        if ref.buffer.name not in known:
                            raise ValueError(
                                f"unknown buffer {ref.buffer.name} in {s}")
                        for e in ref.index:
                            for v, _ in e.coeffs:
                                if v not in loop_env:
                                    raise ValueError(
                                        f"index uses unbound loop var {v} in {s}")
                        # bounds check at the loop extremes (affine, so the
                        # max index occurs at max of each var).
                        hi = {v: ext - 1 for v, ext in loop_env.items()}
                        ref.slices(hi)
                        ref.slices({v: 0 for v in loop_env})

        check(self.body, {})

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List[Stmt]:
        """The kernel's mutable top-level statement list."""
        return self.body

    def rebuild(self, children: Sequence[Stmt]) -> "Kernel":
        return Kernel(self.name, list(self.params), list(self.outputs),
                      list(self.scratch), list(children))

    def is_equivalent(self, other) -> bool:
        """Structural equivalence: identical canonical textual form."""
        from . import ir_text
        return isinstance(other, Kernel) and \
            ir_text.print_kernel(self) == ir_text.print_kernel(other)

    # ---- traversal helpers ---------------------------------------------------

    def walk(self):
        def go(stmts, depth, trail):
            for s in stmts:
                yield s, depth, tuple(trail)
                if isinstance(s, Loop):
                    yield from go(s.body, depth + 1, trail + [s])
        yield from go(self.body, 0, [])

    def loops(self) -> List[Loop]:
        return [s for s, _, _ in self.walk() if isinstance(s, Loop)]

    def find_loop(self, name: str) -> Loop:
        for l in self.loops():
            if l.var.name == name:
                return l
        raise KeyError(f"no loop named {name} in kernel {self.name}")

    def vmem_bytes(self) -> int:
        return sum(b.type.nbytes for b in self.scratch if b.space == MemSpace.VMEM)

    def __str__(self):
        # canonical textual form lives in ir_text (it round-trips through
        # ir_text.parse_kernel); delegate so str() and the parser can't drift.
        from . import ir_text
        return ir_text.print_kernel(self)


def _stmt_refs(s: Stmt) -> List[TileRef]:
    """All tile refs of a statement, written destination FIRST (passes
    and the DSE legality checks rely on refs[0] being the dst).  A
    ScanTile's carry is read AND written; it is listed last — callers
    that care about write sets must treat it as written too (see
    ``_stmt_written_refs``)."""
    if isinstance(s, ZeroTile):
        return [s.dst]
    if isinstance(s, FillTile):
        return [s.dst]
    if isinstance(s, MatmulTile):
        return [s.dst, s.lhs, s.rhs]
    if isinstance(s, EwiseTile):
        return [s.dst, *s.srcs]
    if isinstance(s, ReduceTile):
        return [s.dst, s.src]
    if isinstance(s, ScanTile):
        return [s.dst, *s.srcs, s.carry]
    if isinstance(s, Loop):
        return []
    raise TypeError(f"unknown stmt {type(s)}")


def _stmt_written_refs(s: Stmt) -> List[TileRef]:
    """Tile refs a statement writes (dst, plus a ScanTile's carry)."""
    if isinstance(s, ScanTile):
        return [s.dst, s.carry]
    refs = _stmt_refs(s)
    return refs[:1]
