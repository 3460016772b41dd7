"""HwIR — level-3 (hardware) dialect of the stagecc stack.

This is the Calyx/RTL half of the paper's Fig. 1 that the reproduction
previously only *simulated*: a scheduled LoopIR kernel lowers to an
explicit FSM + datapath hardware description, and the TABLE I / Fig. 3
measurements are then derived *structurally* from that hardware (count
FSM steps, registers, datapath lanes, buffer bytes) instead of from
LoopIR-walking heuristics.

An :class:`HwModule` is one synthesisable unit, Calyx-component-shaped:

  * **ports** — the module's memory-mapped I/O (one per HBM kernel
    argument; the AXI interface of the paper's generated IP core);
  * **regs** — architectural registers: accumulator tiles that lived in
    ``@vreg`` (loop counters are implicit in the control tree — each
    ``@fsm``/``@stream`` loop owns one);
  * **mems** — on-chip RAMs (``@vmem`` scratch; the BRAM analogue);
  * **units** — datapath functional units (``mac`` scalar multiply-
    accumulate, ``mxu`` systolic tile engine, ``vpu`` elementwise lane
    array), each with a geometry (lanes per copy) and a spatial
    ``copies`` count ( > 1 under unrolled/vector loops);
  * **ctrl** — the control program, Calyx-control-shaped: ``HwStep``
    leaves (one datapath invocation ≙ one FSM state) under ``HwLoop``
    nodes whose kind says how the hardware sequences them:

      - ``fsm``     — an FSM-stepped (time-multiplexed) loop: one body
                      datapath, a counter register, a state transition
                      per iteration (LoopIR ``@seq``);
      - ``unroll``  — spatially replicated body hardware, control paid
                      once; stays memory-port-limited (LoopIR
                      ``@unrolled``, the paper's inner-flattening);
      - ``simd``    — true SIMD lane replication (LoopIR ``@vector``);
      - ``stream``  — a grid sequencer with double-buffered DMA: memory
                      traffic overlaps compute across steps (LoopIR
                      ``@grid``, the pallas-grid analogue).

Every step operand carries an affine *address generator* (``index``) in
the enclosing loop counters, so the hardware level is **executable**:
``hw_sim.simulate`` walks the control tree cycle-by-cycle against real
numpy buffers (the Vivado-simulation role), and ``host_bridge`` couples
the module to a modelled host CPU over a crossbar (the paper's AXI/CSR
integration).

``lower_to_hw`` is the only producer; ``emit_verilog`` pretty-prints a
Verilog-style module (FSM state encoding, counters, register/memory
declarations, generate-replicated units) and the textual round-trip form
lives in ``ir_text`` (``print(parse(print(hw)))`` is a fixpoint, like
the two levels above).  ``machine_model.cycles``/``resources`` price an
``HwModule``; this module deliberately knows nothing about cost.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .loop_ir import (AffineExpr, EwiseTile, FillTile, Kernel, Loop, LoopKind,
                      MatmulTile, MemSpace, ReduceTile, ScanTile, Stmt,
                      TileRef, ZeroTile)
from .tensor_ir import dtype_bytes

#: LoopIR loop kinds -> HwIR sequencing disciplines
CTRL_OF_LOOPKIND = {
    LoopKind.SEQUENTIAL: "fsm",
    LoopKind.UNROLLED: "unroll",
    LoopKind.VECTOR: "simd",
    LoopKind.GRID: "stream",
}
LOOP_CTRL_KINDS = tuple(CTRL_OF_LOOPKIND.values())

#: datapath unit kinds
UNIT_KINDS = ("mac", "mxu", "vpu")

#: ops that an MXU tile engine can be invoked with
_MATMUL_OPS = ("matmul",)


# --------------------------------------------------------------------------
# storage + datapath declarations
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HwPort:
    """Module I/O.  Top-level module ports are backed by off-chip (HBM)
    memory — the AXI channel.  Sub-module ports declare the ``space``
    of the parent storage they are bound to at each instance site
    (``hbm``/``vmem``/``vreg``), so pricing stays honest through the
    hierarchy: a port backed by a parent register tile costs what a
    register read costs, not an HBM burst."""

    name: str
    direction: str                  # "in" | "out" | "inout"
    dtype: str                      # element type, e.g. float32
    shape: Tuple[int, ...]          # backing array shape (elements)
    space: str = "hbm"              # "hbm" | "vmem" | "vreg"

    def __post_init__(self):
        if self.direction not in ("in", "out", "inout"):
            raise ValueError(f"port {self.name}: bad direction "
                             f"{self.direction!r}")
        if self.space not in ("hbm", "vmem", "vreg"):
            raise ValueError(f"port {self.name}: bad space {self.space!r}")

    @property
    def elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def width_bits(self) -> int:
        return 8 * dtype_bytes(self.dtype)


@dataclasses.dataclass(frozen=True)
class HwReg:
    """An architectural register bank (a VREG tile): ``elems`` parallel
    registers of ``width_bits`` each."""

    name: str
    dtype: str
    shape: Tuple[int, ...]

    @property
    def elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def width_bits(self) -> int:
        return 8 * dtype_bytes(self.dtype)


@dataclasses.dataclass(frozen=True)
class HwMem:
    """An on-chip RAM (VMEM scratch — the BRAM analogue)."""

    name: str
    dtype: str
    shape: Tuple[int, ...]

    @property
    def elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytes(self) -> int:
        return self.elems * dtype_bytes(self.dtype)


@dataclasses.dataclass(frozen=True)
class HwUnit:
    """A datapath functional unit instance.

    ``geometry`` is the unit's internal parallelism (lanes of one copy):
    ``(m, n)`` output tile for ``mxu``/``mac``, ``(elems,)`` for ``vpu``.
    ``copies`` > 1 means the unit is spatially replicated (it sits under
    an unrolled/vector loop) — the Fig.-3 "hardware grows with matrix
    size" mechanism.
    """

    name: str
    kind: str                       # "mac" | "mxu" | "vpu"
    geometry: Tuple[int, ...]
    copies: int = 1

    def __post_init__(self):
        if self.kind not in UNIT_KINDS:
            raise ValueError(f"unit {self.name}: bad kind {self.kind!r}")
        if self.copies < 1:
            raise ValueError(f"unit {self.name}: copies must be >= 1")

    @property
    def lanes(self) -> int:
        """Spatial compute lanes of one copy (DSP analogue)."""
        return int(np.prod(self.geometry)) if self.geometry else 1


@dataclasses.dataclass(frozen=True)
class HwBinding:
    """One row of the module's resource-binding table: control steps that
    invoke the *virtual* unit ``virtual`` actually execute on the shared
    physical unit ``unit``.

    ``copies`` records the spatial replication the virtual unit was
    lowered with; when the physical unit provides fewer copies, each
    activation of the bound step group serializes into ``serial``
    sequential rounds (``serial = ceil(copies / physical.copies)``) —
    the time-multiplexing the ``share-units`` scheduler trades area for.
    """

    virtual: str                    # name steps reference
    unit: str                       # physical HwUnit name
    serial: int = 1                 # sequential rounds per activation
    copies: int = 1                 # spatial copies of the virtual unit

    def __post_init__(self):
        if self.serial < 1:
            raise ValueError(f"binding {self.virtual}: serial must be >= 1")
        if self.copies < 1:
            raise ValueError(f"binding {self.virtual}: copies must be >= 1")


# --------------------------------------------------------------------------
# control
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HwOperand:
    """One datapath operand: a tile of a port/mem/reg touched per invoke.

    ``role`` is the dataflow direction seen from the unit: ``read``,
    ``write``, or ``acc`` (read-modify-write accumulation).

    ``index`` is the operand's address generator: one affine function of
    the enclosing loop counters per storage dimension, in units of the
    tile size for that dimension — the same block-index addressing as
    :class:`~repro_torch.core.loop_ir.TileRef`.  This is what makes HwIR
    *executable* (``hw_sim`` walks these to real numpy slices) rather
    than merely priceable.
    """

    role: str                       # "read" | "write" | "acc"
    target: str                     # name of a port / mem / reg
    tile: Tuple[int, ...]           # elements moved per invocation
    index: Tuple[AffineExpr, ...] = ()  # block index per storage dim

    def __post_init__(self):
        if self.role not in ("read", "write", "acc"):
            raise ValueError(f"operand {self.target}: bad role {self.role!r}")

    @property
    def elems(self) -> int:
        return int(np.prod(self.tile)) if self.tile else 1

    def slices(self, shape: Tuple[int, ...],
               env: Dict[str, int]) -> Tuple[slice, ...]:
        """Numpy slices of this operand's tile inside storage of ``shape``
        under counter bindings ``env`` (mirrors ``TileRef.slices``)."""
        if len(self.index) != len(shape):
            raise IndexError(
                f"operand {self.target}: index rank {len(self.index)} does "
                f"not match storage rank {len(shape)} — module built "
                f"without address generators?")
        out = []
        for e, t, d in zip(self.index, self.tile, shape):
            start = e.evaluate(env) * t
            if start < 0 or start + t > d:
                raise IndexError(
                    f"operand {self.target}: tile [{start}:{start + t}] out "
                    f"of bounds (dim {d})")
            out.append(slice(start, start + t))
        return tuple(out)


@dataclasses.dataclass
class HwCtrl:
    """Base class of control-tree nodes."""

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List["HwCtrl"]:
        return []

    def rebuild(self, children: Sequence["HwCtrl"]) -> "HwCtrl":
        assert not children
        return dataclasses.replace(self)

    def is_equivalent(self, other) -> bool:
        from . import ir_text
        return isinstance(other, HwCtrl) and \
            ir_text.print_hw_ctrl(self) == ir_text.print_hw_ctrl(other)


@dataclasses.dataclass
class HwStep(HwCtrl):
    """One FSM state: invoke ``unit`` with ``op`` over ``operands``.

    Operand order is significant for multi-operand ops (matmul: dst,
    lhs, rhs — mirroring ``MatmulTile``).
    """

    op: str                         # "matmul" | "zero" | vpu op name
    unit: str                       # HwUnit name (or a binding's virtual)
    operands: List[HwOperand]


@dataclasses.dataclass
class HwInstance(HwCtrl):
    """One FSM state that invokes a sub-module definition.

    ``portmap`` carries one operand per sub-module port, in port order:
    the operand's target/index/tile name the region of *parent* storage
    the port is bound to for this call site.  The operand role mirrors
    the port direction (``in``→``read``, ``out``→``write``,
    ``inout``→``acc``).  The sub-module runs its own control program to
    completion before the parent FSM advances — a call, not a fork.
    """

    module: str                     # name in the parent's submodule table
    portmap: List[HwOperand]

    def rebuild(self, children: Sequence["HwCtrl"]) -> "HwInstance":
        assert not children
        return HwInstance(self.module, list(self.portmap))


@dataclasses.dataclass
class HwLoop(HwCtrl):
    """A hardware-sequenced loop: ``counter`` is the implicit counter
    register (``fsm``/``stream``) or the replication index
    (``unroll``/``simd``)."""

    counter: str
    trips: int
    kind: str                       # "fsm" | "unroll" | "simd" | "stream"
    body: List[HwCtrl]

    def __post_init__(self):
        if self.kind not in LOOP_CTRL_KINDS:
            raise ValueError(f"loop %{self.counter}: bad kind {self.kind!r}")

    def children(self) -> List[HwCtrl]:
        return self.body

    def rebuild(self, children: Sequence[HwCtrl]) -> "HwLoop":
        return HwLoop(self.counter, self.trips, self.kind, list(children))

    @property
    def counter_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.trips))))


def _walk_ctrl(nodes: Sequence[HwCtrl], depth: int = 0, trail=()):
    """Yield ``(node, depth, trail)`` over a control forest."""
    for n in nodes:
        yield n, depth, tuple(trail)
        if isinstance(n, HwLoop):
            yield from _walk_ctrl(n.body, depth + 1, tuple(trail) + (n,))


# --------------------------------------------------------------------------
# module
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HwModule:
    """One hardware module: storage + datapath + control, plus (for the
    hierarchical, shared-resource form) a sub-module definition table and
    a resource-binding table.  ``submodules`` hold outlined subcircuit
    definitions instanced from the control tree via :class:`HwInstance`;
    ``bindings`` map virtual unit names (what steps reference) onto
    shared physical :class:`HwUnit` declarations."""

    name: str
    ports: List[HwPort]
    regs: List[HwReg]
    mems: List[HwMem]
    units: List[HwUnit]
    ctrl: List[HwCtrl]
    submodules: List["HwModule"] = dataclasses.field(default_factory=list)
    bindings: List[HwBinding] = dataclasses.field(default_factory=list)

    # ---- symbol tables -----------------------------------------------------

    def storage(self, name: str):
        for coll in (self.ports, self.regs, self.mems):
            for d in coll:
                if d.name == name:
                    return d
        raise KeyError(f"no storage named {name!r} in module {self.name}")

    def space_of(self, name: str) -> MemSpace:
        d = self.storage(name)
        if isinstance(d, HwPort):
            return MemSpace(d.space)
        if isinstance(d, HwMem):
            return MemSpace.VMEM
        return MemSpace.VREG

    def binding_of(self, name: str) -> Optional[HwBinding]:
        """The binding-table row whose virtual name is ``name``, if any."""
        for b in self.bindings:
            if b.virtual == name:
                return b
        return None

    def unit(self, name: str) -> HwUnit:
        """Resolve a step's unit reference — through the binding table
        first (virtual → physical), then the declaration list."""
        b = self.binding_of(name)
        if b is not None:
            name = b.unit
        for u in self.units:
            if u.name == name:
                return u
        raise KeyError(f"no unit named {name!r} in module {self.name}")

    def submodule(self, name: str) -> "HwModule":
        for s in self.submodules:
            if s.name == name:
                return s
        raise KeyError(f"no submodule named {name!r} in module {self.name}")

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List[HwCtrl]:
        """The module's mutable top-level control list."""
        return self.ctrl

    def rebuild(self, children: Sequence[HwCtrl]) -> "HwModule":
        return HwModule(self.name, list(self.ports), list(self.regs),
                        list(self.mems), list(self.units), list(children),
                        submodules=list(self.submodules),
                        bindings=list(self.bindings))

    def is_equivalent(self, other) -> bool:
        """Structural equivalence: identical canonical textual form."""
        from . import ir_text
        return isinstance(other, HwModule) and \
            ir_text.print_hw_module(self) == ir_text.print_hw_module(other)

    # ---- traversal ---------------------------------------------------------

    def walk(self):
        """Yield ``(node, depth, trail)`` over the control tree, where
        ``trail`` is the tuple of enclosing :class:`HwLoop` nodes."""
        yield from _walk_ctrl(self.ctrl)

    def steps(self) -> List[HwStep]:
        return [n for n, _, _ in self.walk() if isinstance(n, HwStep)]

    def loops(self) -> List[HwLoop]:
        return [n for n, _, _ in self.walk() if isinstance(n, HwLoop)]

    # ---- structural accounting (what the Vivado report would count) --------

    def fsm_state_count(self) -> int:
        """Number of states in the flattened control FSM (hierarchical
        total: every sub-module definition owns its own controller,
        counted once however many instances reference it).

        Every :class:`HwStep` is one state; an :class:`HwInstance` is one
        call state in the parent.  ``fsm``/``stream`` loops add one
        header state (test + counter increment); ``unroll``/``simd``
        bodies are spatial, so their body contributes its states once and
        no header exists.  An idle/done state closes each machine.
        """

        def go(nodes) -> int:
            n = 0
            for node in nodes:
                if isinstance(node, (HwStep, HwInstance)):
                    n += 1
                elif node.kind in ("fsm", "stream"):
                    n += 1 + go(node.body)
                else:                       # unroll / simd: spatial
                    n += go(node.body)
            return n

        return (1 + go(self.ctrl)           # + idle/done
                + sum(s.fsm_state_count() for s in self.submodules))

    def state_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.fsm_state_count()))))

    def register_bits(self) -> int:
        """Total architectural register bits: declared register banks plus
        the loop counters implied by sequenced loops plus the FSM state
        register (the FF part of the FF/LUT report); sub-module
        definitions contribute their own bits once."""
        bits = sum(r.elems * r.width_bits for r in self.regs)
        bits += sum(l.counter_bits for l in self.loops()
                    if l.kind in ("fsm", "stream"))
        return (bits + self.state_bits()
                + sum(s.register_bits() for s in self.submodules))

    def mem_bytes(self) -> int:
        return (sum(mm.bytes for mm in self.mems)
                + sum(s.mem_bytes() for s in self.submodules))

    def lane_count(self) -> int:
        """Peak spatial compute lanes (the DSP column of Fig. 3)."""
        return max([u.lanes * u.copies for u in self.units]
                   + [s.lane_count() for s in self.submodules] or [0])

    def total_lanes(self) -> int:
        """Summed spatial compute lanes over every declared unit plus
        every sub-module definition counted once — the quantity resource
        sharing actually shrinks (a shared physical unit is one decl,
        however many virtual names bind to it)."""
        return (sum(u.lanes * u.copies for u in self.units)
                + sum(s.total_lanes() for s in self.submodules))

    def _unit_users(self) -> Dict[str, int]:
        """Physical unit name -> number of distinct users (direct step
        references + binding-table rows) competing for its ports."""
        unit_names = {u.name for u in self.units}
        users = {n: 0 for n in unit_names}
        for name in {s.unit for s in self.steps() if s.unit in unit_names}:
            users[name] += 1
        for b in self.bindings:
            if b.unit in users:
                users[b.unit] += 1
        return users

    def mux_bits(self) -> int:
        """Input-select overhead of time-multiplexing: every user of a
        physical unit beyond the first needs a lanes-wide 2:1 mux on each
        of the unit's two operand buses.  Zero for unshared modules."""
        users = self._unit_users()
        bits = 0
        for u in self.units:
            bits += max(0, users[u.name] - 1) * u.lanes * u.copies * 2
        return bits + sum(s.mux_bits() for s in self.submodules)

    def shared_unit_count(self) -> int:
        """Number of physical units that are time-multiplexed (referenced
        through at least one binding-table row), hierarchy-wide."""
        bound = {b.unit for b in self.bindings}
        return (sum(1 for u in self.units if u.name in bound)
                + sum(s.shared_unit_count() for s in self.submodules))

    # ---- verification ------------------------------------------------------

    def verify(self) -> None:
        # ports/regs/mems share one storage namespace; name the duplicate
        seen: set = set()
        for d in self.ports + self.regs + self.mems:
            if d.name in seen:
                raise ValueError(
                    f"duplicate storage name {d.name!r} in module "
                    f"{self.name} (ports, regs and mems share a namespace)")
            seen.add(d.name)
        unit_seen: set = set()
        for u in self.units:
            if u.name in unit_seen:
                raise ValueError(f"duplicate unit name {u.name!r} in module "
                                 f"{self.name}")
            unit_seen.add(u.name)
        sub_seen: set = set()
        for s in self.submodules:
            if s.name in sub_seen:
                raise ValueError(f"duplicate submodule name {s.name!r} in "
                                 f"module {self.name}")
            sub_seen.add(s.name)
            s.verify()
        bind_seen: set = set()
        for b in self.bindings:
            if b.virtual in bind_seen:
                raise ValueError(f"duplicate binding for virtual unit "
                                 f"{b.virtual!r} in module {self.name}")
            if b.virtual in unit_seen:
                raise ValueError(
                    f"binding {b.virtual!r} shadows a unit declaration in "
                    f"module {self.name} (virtual and physical names are "
                    f"disjoint namespaces)")
            bind_seen.add(b.virtual)
            if b.unit not in unit_seen:
                raise ValueError(
                    f"binding {b.virtual} -> {b.unit}: no unit named "
                    f"{b.unit!r} declared in module {self.name}")
        def check_operand(opnd, scope):
            d = self.storage(opnd.target)       # raises on unknown name
            rank = len(d.shape)
            if len(opnd.tile) != rank or len(opnd.index) != rank:
                raise ValueError(
                    f"operand {opnd.target}: index/tile rank "
                    f"({len(opnd.index)}/{len(opnd.tile)}) does not "
                    f"match storage rank {rank}")
            for e in opnd.index:
                for v, _ in e.coeffs:
                    if v not in scope:
                        raise ValueError(
                            f"operand {opnd.target}: index uses "
                            f"counter %{v} not bound by an "
                            f"enclosing loop")
            # bounds over the whole iteration box, sign-aware per
            # coefficient (a mixed-sign index like i1+-1*k3 takes
            # its extrema at different corners per term)
            for e, t, dim in zip(opnd.index, opnd.tile, d.shape):
                lo = hi = e.const
                for v, s in e.coeffs:
                    ext = scope[v] - 1
                    lo += min(0, s * ext)
                    hi += max(0, s * ext)
                if lo * t < 0 or hi * t + t > dim:
                    raise ValueError(
                        f"operand {opnd.target}: tile range "
                        f"[{lo * t}:{hi * t + t}] out of bounds "
                        f"(dim {dim})")
            return d

        counters = set()
        for node, _, trail in self.walk():
            if isinstance(node, HwLoop):
                if node.trips <= 0:
                    raise ValueError(f"loop %{node.counter} has no trips")
                if node.counter in counters:
                    raise ValueError(f"shadowed counter %{node.counter}")
                if node.counter in seen:
                    raise ValueError(f"loop counter %{node.counter} shadows "
                                     f"a storage name")
                counters.add(node.counter)
            elif isinstance(node, HwInstance):
                if node.module not in sub_seen:
                    raise ValueError(
                        f"instance references unknown submodule "
                        f"@{node.module} in module {self.name}")
                sub = self.submodule(node.module)
                if len(node.portmap) != len(sub.ports):
                    raise ValueError(
                        f"instance @{node.module}: port map has "
                        f"{len(node.portmap)} operands but the module "
                        f"declares {len(sub.ports)} ports")
                scope = {l.counter: l.trips for l in trail}
                for opnd, port in zip(node.portmap, sub.ports):
                    want = {"in": "read", "out": "write",
                            "inout": "acc"}[port.direction]
                    if opnd.role != want:
                        raise ValueError(
                            f"instance @{node.module} port {port.name} "
                            f"({port.direction}) needs a {want} operand, "
                            f"got {opnd.role}")
                    d = check_operand(opnd, scope)
                    if tuple(opnd.tile) != tuple(port.shape):
                        raise ValueError(
                            f"instance @{node.module} port {port.name}: "
                            f"bound tile {tuple(opnd.tile)} does not match "
                            f"port shape {tuple(port.shape)}")
                    if d.dtype != port.dtype:
                        raise ValueError(
                            f"instance @{node.module} port {port.name}: "
                            f"dtype {d.dtype} does not match port dtype "
                            f"{port.dtype}")
                    if self.space_of(opnd.target).value != port.space:
                        raise ValueError(
                            f"instance @{node.module} port {port.name}: "
                            f"bound storage {opnd.target} lives in "
                            f"{self.space_of(opnd.target).value}, port "
                            f"declares {port.space}")
            elif isinstance(node, HwStep):
                u = self.unit(node.unit)
                if node.op in _MATMUL_OPS:
                    if u.kind == "vpu":
                        raise ValueError(
                            f"step {node.op} cannot run on vpu unit {u.name}")
                    if len(node.operands) != 3:
                        raise ValueError(
                            f"step {node.op} needs (dst, lhs, rhs) operands, "
                            f"got {len(node.operands)}")
                    for opnd in node.operands[1:]:
                        if len(opnd.tile) < 2:
                            raise ValueError(
                                f"matmul operand {opnd.target} must be a "
                                f"rank>=2 tile")
                if not node.operands:
                    raise ValueError(f"step {node.op} has no operands")
                scope = {l.counter: l.trips for l in trail}
                for opnd in node.operands:
                    check_operand(opnd, scope)

    def __str__(self):
        from . import ir_text
        return ir_text.print_hw_module(self)


# --------------------------------------------------------------------------
# LoopIR -> HwIR lowering (the CIRCT "calyx-to-hw" role)
# --------------------------------------------------------------------------


class _HwLowerer:
    """Structural translation of a scheduled kernel:

      * HBM params        -> ports (outputs drive write channels)
      * VMEM scratch      -> mems
      * VREG scratch      -> regs
      * leaf statements   -> one datapath unit + one control step each;
        a unit under unrolled/vector loops is replicated ``copies`` times
      * loops             -> control nodes per ``CTRL_OF_LOOPKIND``
    """

    def __init__(self, kernel: Kernel, mxu_min_dim: int = 8,
                 max_unit_lanes: int = 1024):
        kernel.verify()
        self.k = kernel
        self.mxu_min_dim = mxu_min_dim
        self.max_unit_lanes = max_unit_lanes
        self.units: List[HwUnit] = []
        self._uid = 0

    def uid(self, hint: str) -> str:
        self._uid += 1
        return f"{hint}{self._uid}"

    # ---- pieces ------------------------------------------------------------

    def _operand(self, role: str, ref: TileRef) -> HwOperand:
        # the TileRef's affine block index becomes the operand's address
        # generator; HwLoop counters keep the LoopIR variable names, so
        # the expressions stay valid at the hardware level.
        return HwOperand(role, ref.buffer.name, tuple(ref.tile),
                         tuple(ref.index))

    def _new_unit(self, kind: str, geometry: Tuple[int, ...],
                  copies: int) -> HwUnit:
        u = HwUnit(self.uid(kind), kind, geometry, copies)
        self.units.append(u)
        return u

    def _lower_stmt(self, s: Stmt, copies: int) -> HwStep:
        if isinstance(s, MatmulTile):
            mt, kt = s.lhs.tile[-2], s.lhs.tile[-1]
            nt = s.rhs.tile[-1]
            kind = "mxu" if min(mt, nt, kt) >= self.mxu_min_dim else "mac"
            # geometry clamps to the physical array edge (128 for the MXU
            # stand-in); the machine model prices partial tiles itself.
            geometry = (min(mt, 128), min(nt, 128))
            u = self._new_unit(kind, geometry, copies)
            role = "acc" if s.accumulate else "write"
            return HwStep("matmul", u.name,
                          [self._operand(role, s.dst),
                           self._operand("read", s.lhs),
                           self._operand("read", s.rhs)])
        if isinstance(s, ZeroTile):
            u = self._new_unit(
                "vpu", (min(s.dst.tile_elems, self.max_unit_lanes),), copies)
            return HwStep("zero", u.name, [self._operand("write", s.dst)])
        if isinstance(s, EwiseTile):
            u = self._new_unit(
                "vpu", (min(s.dst.tile_elems, self.max_unit_lanes),), copies)
            return HwStep(s.op, u.name,
                          [self._operand("write", s.dst)] +
                          [self._operand("read", r) for r in s.srcs])
        if isinstance(s, FillTile):
            # only the two fill constants lowering emits have a hardware
            # spelling: 0.0 reuses the zero broadcast, the reduce-max
            # identity gets its own op (a constant ROM would be overkill)
            if s.value == 0.0:
                op = "zero"
            elif s.value == -1e30:
                op = "fill_min"
            else:
                raise TypeError(
                    f"no HwIR lowering for fill constant {s.value!r}")
            u = self._new_unit(
                "vpu", (min(s.dst.tile_elems, self.max_unit_lanes),), copies)
            return HwStep(op, u.name, [self._operand("write", s.dst)])
        if isinstance(s, ReduceTile):
            u = self._new_unit(
                "vpu", (min(s.src.tile_elems, self.max_unit_lanes),), copies)
            role = "acc" if s.accumulate else "write"
            return HwStep(f"reduce_{s.kind}", u.name,
                          [self._operand(role, s.dst),
                           self._operand("read", s.src)])
        if isinstance(s, ScanTile):
            u = self._new_unit(
                "vpu", (min(s.dst.tile_elems, self.max_unit_lanes),), copies)
            return HwStep(f"scan_{s.kind}", u.name,
                          [self._operand("write", s.dst),
                           self._operand("acc", s.carry)] +
                          [self._operand("read", r) for r in s.srcs])
        raise TypeError(f"no HwIR lowering for statement {type(s).__name__}")

    def _lower_block(self, stmts: Sequence[Stmt], copies: int) -> List[HwCtrl]:
        out: List[HwCtrl] = []
        for s in stmts:
            if isinstance(s, Loop):
                rep = copies
                if s.kind in (LoopKind.UNROLLED, LoopKind.VECTOR):
                    rep *= s.var.extent
                out.append(HwLoop(s.var.name, s.var.extent,
                                  CTRL_OF_LOOPKIND[s.kind],
                                  self._lower_block(s.body, rep)))
            else:
                out.append(self._lower_stmt(s, copies))
        return out

    # ---- driver ------------------------------------------------------------

    def run(self) -> HwModule:
        ctrl = self._lower_block(self.k.body, 1)
        # port direction follows actual channel usage: HBM intermediates
        # are written by one nest and read by the next (inout), kernel
        # outputs drive a write channel, pure inputs a read channel.
        read, written = set(), set()
        for node, _, _ in _walk_ctrl(ctrl):
            if isinstance(node, HwStep):
                for o in node.operands:
                    (read if o.role == "read" else written).add(o.target)
                    if o.role == "acc":
                        read.add(o.target)
        written |= {b.name for b in self.k.outputs}

        def direction(name: str) -> str:
            if name in written:
                return "inout" if name in read else "out"
            return "in"

        ports = [HwPort(b.name, direction(b.name), b.type.dtype,
                        tuple(b.type.shape))
                 for b in self.k.params]
        regs = [HwReg(b.name, b.type.dtype, tuple(b.type.shape))
                for b in self.k.scratch if b.space == MemSpace.VREG]
        mems = [HwMem(b.name, b.type.dtype, tuple(b.type.shape))
                for b in self.k.scratch if b.space == MemSpace.VMEM]
        mod = HwModule(name=self.k.name, ports=ports, regs=regs, mems=mems,
                       units=self.units, ctrl=ctrl)
        mod.verify()
        return mod


def lower_to_hw(kernel: Kernel, mxu_min_dim: int = 8) -> HwModule:
    """Lower a scheduled LoopIR kernel to an FSM + datapath HwModule.

    The produced module is always verified before being returned
    (:meth:`HwModule.verify` — storage/unit name uniqueness, counter
    scoping, operand rank and bounds), so no caller ever holds an
    unchecked hardware module.
    """
    return _HwLowerer(kernel, mxu_min_dim=mxu_min_dim).run()


def set_sequencer(mod: HwModule, counter: str, kind: str) -> HwModule:
    """Re-sequence loop ``%counter`` between ``fsm`` and ``stream``.

    This is the HwIR-level scheduling knob the DSE drives: an ``fsm``
    loop re-sequenced as ``stream`` gains the grid sequencer's
    double-buffered DMA (memory traffic overlaps compute across steps,
    at the price of the ping-pong buffers), and vice versa.  Only the
    two *temporal* sequencer kinds are interconvertible — rewriting a
    loop to/from the spatial kinds (``unroll``/``simd``) would change
    the datapath replication the module was lowered with, so that stays
    a LoopIR-level decision (``unroll``/``vectorize`` passes).
    """
    if kind not in ("fsm", "stream"):
        raise ValueError(
            f"set-sequencer: kind must be 'fsm' or 'stream', got {kind!r} "
            f"(spatial sequencers are fixed at lower-to-hw time)")
    # lazy import: rewrite.py imports this module for its pattern classes
    from .rewrite import RewriteDriver, SetSequencer

    pat = SetSequencer(counter, kind)
    RewriteDriver([pat], max_iterations=2).run(mod)
    if not pat.applied:
        raise KeyError(f"no loop counter %{counter} in module {mod.name}")
    mod.verify()
    return mod


# --------------------------------------------------------------------------
# Verilog-style emission (the paper's "RTL generation" stage)
# --------------------------------------------------------------------------


def _flat_states(mod: HwModule) -> List[Tuple[str, str]]:
    """Enumerate FSM states as ``(name, comment)`` in execution order,
    matching :meth:`HwModule.fsm_state_count`."""
    states: List[Tuple[str, str]] = [("S_IDLE", "wait for start")]

    def go(nodes, prefix):
        for i, n in enumerate(nodes):
            if isinstance(n, HwStep):
                opnds = ", ".join(o.target for o in n.operands)
                states.append((f"S_{prefix}{i}_{n.op.upper()}",
                               f"invoke {n.unit}.{n.op}({opnds})"))
            elif isinstance(n, HwInstance):
                opnds = ", ".join(o.target for o in n.portmap)
                safe = "".join(c if c.isalnum() else "_" for c in n.module)
                states.append((f"S_{prefix}{i}_CALL_{safe.upper()}",
                               f"invoke submodule {n.module}({opnds}); "
                               f"wait for its done"))
            elif n.kind in ("fsm", "stream"):
                states.append((f"S_{prefix}{i}_{n.counter.upper()}",
                               f"{n.kind} loop %{n.counter}: test/increment "
                               f"({n.trips} trips)"))
                go(n.body, f"{prefix}{i}_")
            else:
                # spatial: body hardware replicated, single control step set
                go(n.body, f"{prefix}{i}_")

    go(mod.ctrl, "")
    return states


def emit_verilog(mod: HwModule) -> str:
    """Pretty-print ``mod`` as a Verilog-style module.

    The output is a readable structural description (FSM state encoding,
    counters, register banks, RAMs, generate-replicated units), not a
    synthesis-clean netlist — it is the textual artifact the paper's
    pipeline hands to Vivado, emitted so cycle/resource numbers can be
    audited against real structure.

    Sub-module definitions are emitted as real Verilog modules of their
    own (named ``{parent}_{sub}``) after the parent, each instantiated
    once in the parent's datapath section — instead of the pre-sharing
    form's N inlined copies.  Plain modules (no submodules, no bindings)
    emit byte-identically to the flat form.
    """
    mod.verify()
    texts = []

    def collect(m: HwModule, name: str):
        texts.append(_emit_one(m, name))
        for sub in m.submodules:
            collect(sub, f"{name}_{sub.name}")

    collect(mod, mod.name)
    return "\n\n".join(texts)


def _emit_one(mod: HwModule, modname: str) -> str:
    states = _flat_states(mod)
    sbits = mod.state_bits()
    lines: List[str] = []
    w = lines.append

    w(f"// stagecc HwIR — module {modname}")
    w(f"// fsm: {mod.fsm_state_count()} states, "
      f"{mod.register_bits()} register bits, "
      f"{mod.mem_bytes()} RAM bytes, "
      f"{mod.lane_count()} datapath lanes")
    w(f"module {modname} (")
    w("  input  wire clk,")
    w("  input  wire rst,")
    w("  input  wire start,")
    port_lines = ["  output reg  done"]
    for p in mod.ports:
        shape = "x".join(str(d) for d in p.shape) or "1"
        addr_bits = max(1, (max(p.elems, 1) - 1).bit_length())
        addr = f"[{addr_bits - 1}:0]"
        port_lines.append(f"  // {p.name}: {p.dtype}[{shape}] @{p.space} "
                          f"({p.direction})")
        if p.direction in ("in", "inout"):
            port_lines.append(f"  output reg  {addr} {p.name}_raddr")
            port_lines.append(f"  input  wire [{p.width_bits-1}:0] "
                              f"{p.name}_rdata")
        if p.direction in ("out", "inout"):
            port_lines.append(f"  output reg  {addr} {p.name}_waddr")
            port_lines.append(f"  output reg  [{p.width_bits-1}:0] "
                              f"{p.name}_wdata")
            port_lines.append(f"  output reg  {p.name}_wen")
    for i, pl in enumerate(port_lines):
        sep = "" if i == len(port_lines) - 1 else ","
        w(pl if pl.lstrip().startswith("//") else pl + sep)
    w(");")
    w("")
    w(f"  // ---- control FSM: {len(states)} states ----")
    for i, (name, _) in enumerate(states):
        w(f"  localparam {name} = {sbits}'d{i};")
    w(f"  reg [{sbits-1}:0] state;")
    fsm_loops = [l for l in mod.loops() if l.kind in ("fsm", "stream")]
    if fsm_loops:
        w("")
        w("  // ---- loop counters ----")
        for l in fsm_loops:
            w(f"  reg [{l.counter_bits-1}:0] {l.counter};"
              f"  // {l.kind} loop, {l.trips} trips")
    if mod.regs:
        w("")
        w("  // ---- register banks (VREG tiles) ----")
        for r in mod.regs:
            shape = "x".join(str(d) for d in r.shape) or "1"
            w(f"  reg [{r.width_bits-1}:0] {r.name} [0:{max(r.elems-1, 0)}];"
              f"  // {r.dtype}[{shape}]")
    if mod.mems:
        w("")
        w("  // ---- on-chip RAMs (VMEM) ----")
        for mm in mod.mems:
            shape = "x".join(str(d) for d in mm.shape) or "1"
            w(f"  reg [{8*dtype_bytes(mm.dtype)-1}:0] "
              f"{mm.name} [0:{max(mm.elems-1, 0)}];"
              f"  // {mm.dtype}[{shape}], {mm.bytes} bytes")
    w("")
    w("  // ---- datapath units ----")
    for u in mod.units:
        geo = "x".join(str(g) for g in u.geometry) or "1"
        bound = [b for b in mod.bindings if b.unit == u.name]
        if bound:
            shared = ", ".join(
                b.virtual + (f" (serial={b.serial})" if b.serial > 1 else "")
                for b in bound)
            w(f"  // shared across FSM states — input mux selects among: "
              f"{shared}")
        if u.copies > 1:
            w(f"  genvar {u.name}_g;")
            w(f"  generate for ({u.name}_g = 0; {u.name}_g < {u.copies}; "
              f"{u.name}_g = {u.name}_g + 1) begin : {u.name}_lanes")
            w(f"    stagecc_{u.kind} #(.GEOMETRY(\"{geo}\")) {u.name} ();")
            w("  end endgenerate")
        else:
            w(f"  stagecc_{u.kind} #(.GEOMETRY(\"{geo}\")) {u.name} ();")
    if mod.submodules:
        w("")
        w("  // ---- submodule instances (one def, N call-site states) ----")
        for sub in mod.submodules:
            calls = sum(1 for n, _, _ in mod.walk()
                        if isinstance(n, HwInstance) and n.module == sub.name)
            w(f"  {modname}_{sub.name} {sub.name}_i (.clk(clk), .rst(rst), "
              f".start({sub.name}_start), .done({sub.name}_done));"
              f"  // {calls} call site(s)")
    w("")
    w("  // ---- schedule ----")
    w("  always @(posedge clk) begin")
    w("    if (rst) begin")
    w("      state <= S_IDLE;")
    w("      done  <= 1'b0;")
    w("    end else begin")
    w("      case (state)")
    for i, (name, comment) in enumerate(states):
        nxt = states[i + 1][0] if i + 1 < len(states) else "S_IDLE"
        w(f"        {name}: begin  // {comment}")
        if i == 0:
            w(f"          if (start) state <= "
              f"{nxt if len(states) > 1 else 'S_IDLE'};")
            w("          done <= 1'b0;" if len(states) > 1
              else "          done <= 1'b1;")
        else:
            w(f"          state <= {nxt};")
            if i == len(states) - 1:
                w("          done  <= 1'b1;")
        w("        end")
    w("        default: state <= S_IDLE;")
    w("      endcase")
    w("    end")
    w("  end")
    w("")
    w("endmodule")
    return "\n".join(lines)
