"""Machine description + structural cycle/resource models over HwIR.

The paper reports consumed clock cycles (TABLE I) and hardware
utilisation (Fig. 3) of the RTL generated from each schedule.  The
reproduction has a hardware level: scheduled LoopIR lowers
to :class:`~repro_torch.core.hw_ir.HwModule` (FSM + datapath), and the models
below walk the *hardware structure* — FSM states and loop sequencers,
datapath units and their spatial copies, register banks and RAMs —
rather than re-deriving costs from LoopIR heuristics:

  * ``cycles(hw)``    — consumed clock cycles of the module's schedule:
    each FSM-sequenced loop pays a state transition per trip, each
    datapath invocation pays its unit's latency, and memory-port traffic
    is priced per port class (TABLE I analogue);
  * ``resources(hw)`` — spatial consumption read off the module: peak
    datapath lanes (DSP analogue), RAM bytes (BRAM analogue), live
    register tiles plus FSM/counter register bits (FF/LUT analogue),
    and the flattened FSM state count (Fig. 3 analogue).

Both accept a scheduled LoopIR ``Kernel`` for convenience and lower it
to hardware first — the accounting itself only ever sees the HwModule.

The model reproduces the paper's *mechanism*:

  * an ``@fsm`` loop is time-division multiplexing — one datapath copy,
    an FSM state transition paid every iteration (Calyx emits exactly
    such an FSM per control transition);
  * an ``@unroll`` loop replicates datapath copies spatially and drops
    the per-iteration FSM transition, but stays memory-port-limited, so
    resources grow with the unroll factor while cycles shrink only by
    the removed control — the paper's TABLE I / Fig. 3 trade.

The constants of ``TPU_V5E`` are the parameters of the modelled TPU v5e
core that the cycle and resource reports are priced on (197 TFLOP/s bf16,
819 GB/s HBM, ~50 GB/s/link ICI, ~940 MHz in that model).  They are kept
so that the reports match the JAX package's number for number; they are
no speed of this port or of the GPU it runs on.

FLOP / HBM-byte accounting for roofline math (``flops``, ``hbm_bytes``)
stays at the LoopIR level: it characterises the *workload*, not the
generated hardware.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple, Union

from . import hw_ir
from .hw_ir import HwCtrl, HwLoop, HwModule, HwStep
from .loop_ir import Kernel, Loop, MatmulTile, MemSpace, TileRef
from .tensor_ir import dtype_bytes


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """One TPU v5e core (the unit the paper's single FPGA kernel maps to)."""

    name: str = "tpu_v5e"
    clock_ghz: float = 0.94
    # MXU: 128x128 systolic array; a (128,128)x(128,128) tile matmul retires
    # in ~128 cycles once the pipeline is primed.
    mxu_dim: int = 128
    # VPU: 8 sublanes x 128 lanes = 1024 f32 ALUs.
    vpu_lanes: int = 1024
    # Cost of one FSM state-transition chain per loop iteration (compare /
    # counter-increment / state register update).  Calibrated (with the
    # scalar-MAC costs below) so the nested/flattened cycle ratio of the
    # scalar GEMM schedules reproduces the paper's TABLE I
    # (1.34x @4x4 .. 1.43x @128).
    seq_loop_overhead_cycles: float = 5.46
    # One-off sequencer setup cost per loop.
    loop_setup_cycles: float = 1.0
    # Handshake cost of invoking an outlined submodule (start/done edge
    # plus the parent FSM's wait state).
    call_overhead_cycles: float = 2.0
    # scalar MAC unit: compute (multiply+add+acc-writeback) and per-
    # operand-element load cost; the datapath is memory-PORT-limited, so
    # spatial unrolling does not speed these up (it removes only the
    # per-iteration control) — exactly the paper's observed mechanism.
    scalar_mac_compute_cycles: float = 9.1
    scalar_load_cycles_per_elem: float = 1.82
    # matmuls with every dim >= this lower onto the systolic MXU unit
    mxu_min_dim: int = 8
    # modelled TPU v5e HBM <-> VMEM bandwidth in bytes/cycle (its 819 GB/s
    # over its 0.94 GHz); not a rate of the GPU.
    hbm_bytes_per_cycle: float = 871.0
    # VMEM <-> compute bandwidth (order of magnitude wider than HBM).
    vmem_bytes_per_cycle: float = 8192.0
    vmem_capacity_bytes: int = 128 * 1024 * 1024  # 128 MiB on v5e
    # the modelled TPU v5e's bf16 peak; not a rate of the GPU.
    peak_flops: float = 197e12
    hbm_gbps: float = 819e9
    ici_gbps_per_link: float = 50e9


TPU_V5E = MachineModel()

#: what the models accept: hardware, or a scheduled kernel to be lowered
HwLike = Union[HwModule, Kernel]


def _as_hw(x: HwLike, m: MachineModel) -> HwModule:
    if isinstance(x, HwModule):
        return x
    return hw_ir.lower_to_hw(x, mxu_min_dim=m.mxu_min_dim)


@dataclasses.dataclass
class CycleReport:
    total: int
    compute: int
    memory: int
    control: int

    def __str__(self):
        return (f"cycles(total={self.total:,}, compute={self.compute:,}, "
                f"memory={self.memory:,}, control={self.control:,})")


@dataclasses.dataclass
class ResourceReport:
    """Spatial consumption — the Fig. 3 analogue."""

    compute_lanes: int       # peak datapath lanes x copies (DSP analogue)
    vmem_bytes: int          # on-chip RAM bytes (BRAM analogue)
    vreg_tiles: int          # live register tiles (FF/LUT analogue)
    fsm_states: int = 0      # flattened control-FSM states
    reg_bits: int = 0        # architectural + counter + state register bits
    total_lanes: int = 0     # summed lanes x copies across every unit decl
    mux_bits: int = 0        # input-mux overhead of time-multiplexed units
    shared_units: int = 0    # physical units carrying >= 1 binding

    def __str__(self):
        return (f"resources(lanes={self.compute_lanes:,}, "
                f"vmem={self.vmem_bytes:,}B, vregs={self.vreg_tiles}, "
                f"fsm_states={self.fsm_states}, reg_bits={self.reg_bits})")


# --------------------------------------------------------------------------
# Cycle model — walks the HwModule control tree
# --------------------------------------------------------------------------


def _operand_bytes(mod: HwModule, opnd: hw_ir.HwOperand) -> int:
    return opnd.elems * dtype_bytes(mod.storage(opnd.target).dtype)


def _port_cycles(mod: HwModule, opnd: hw_ir.HwOperand, m: MachineModel,
                 vreg_free: bool) -> float:
    """Memory-port cost of moving one operand tile."""
    space = mod.space_of(opnd.target)
    if space == MemSpace.HBM:
        return _operand_bytes(mod, opnd) / m.hbm_bytes_per_cycle
    if space == MemSpace.VMEM or not vreg_free:
        return _operand_bytes(mod, opnd) / m.vmem_bytes_per_cycle
    return 0.0      # register-file operands ride dedicated bypass paths


def _binding_control(step: HwStep, mod: HwModule, m: MachineModel) -> float:
    """Serialization cost of running ``step`` on a time-multiplexed unit.

    A binding with ``serial > 1`` means the virtual unit's spatial copies
    are replayed on fewer physical copies: each dynamic invocation pays
    ``serial - 1`` extra sequencing transitions.  The charge is spread
    over the virtual copies because the enclosing ``@unroll`` executes
    the step once per copy — summed over the replication this totals
    ``seq_loop_overhead_cycles * (serial - 1)`` per logical use.
    """
    b = mod.binding_of(step.unit)
    if b is None or b.serial <= 1:
        return 0.0
    return m.seq_loop_overhead_cycles * (b.serial - 1) / max(1, b.copies)


def step_cycles(step: HwStep, mod: HwModule, m: MachineModel,
                simd_lanes: int) -> Dict[str, float]:
    """Cycles for one invocation of a datapath unit.

    ``simd_lanes`` > 1 when the step sits under ``@simd`` loops (true
    SIMD with widened ports).  Plain ``@unroll`` replication does NOT
    speed an invocation up: the unit stays memory-port-limited, so
    spatial flattening removes only control — the paper's measured
    behaviour (TABLE I gains of 1.34-1.43x for proportional hardware
    growth in Fig. 3).

    Steps bound onto a shared physical unit with ``serial > 1`` carry an
    extra ``"control"`` entry: the serialization stall is priced, not
    hidden (identical formula in the simulator keeps cosim symmetric).
    """
    unit = mod.unit(step.unit)
    ctrl = _binding_control(step, mod, m)
    if step.op == "zero":
        elems = step.operands[0].elems
        compute = max(1.0, elems / min(m.vpu_lanes,
                                       simd_lanes * max(1, elems)))
        return {"compute": compute, "memory": 0.0, "control": ctrl}
    if step.op == "matmul":
        dst, lhs, rhs = step.operands
        mt, kt = lhs.tile[-2], lhs.tile[-1]
        nt = rhs.tile[-1]
        if unit.kind == "mxu":
            # systolic regime: ceil-div each output dim to the array grid;
            # a pass costs k-depth cycles (pipelined) per array tile.
            tiles = (math.ceil(mt / m.mxu_dim) * math.ceil(nt / m.mxu_dim))
            compute = tiles * max(kt, m.mxu_dim)
            mem = sum(_port_cycles(mod, o, m, vreg_free=False)
                      for o in (lhs, rhs, dst))
            return {"compute": compute, "memory": mem, "control": ctrl}
        # scalar MAC unit (the paper's Calyx-generated GEMM datapath)
        macs = mt * nt * kt
        compute = m.scalar_mac_compute_cycles * macs / simd_lanes
        loads = (mt * kt + kt * nt) * m.scalar_load_cycles_per_elem
        return {"compute": compute, "memory": loads, "control": ctrl}
    # vpu elementwise
    elems = step.operands[0].elems
    compute = max(1.0, elems / min(m.vpu_lanes, simd_lanes))
    mem = sum(_port_cycles(mod, o, m, vreg_free=True)
              for o in step.operands)
    return {"compute": compute, "memory": mem, "control": ctrl}


def cycles(x: HwLike, m: MachineModel = TPU_V5E) -> CycleReport:
    """Walk the hardware module's control tree and accumulate cycles.

    ``@fsm`` loops multiply body cost by the trip count and add an FSM
    state transition per trip (time-division multiplexing of one
    datapath copy).  ``@unroll`` loops multiply work by the trip count
    but pay control only ONCE: spatial flattening removes the FSM
    transitions yet stays port-limited — the paper's TABLE I mechanism
    (1.34-1.43x, not trips-x, speedups).  ``@simd`` loops are true SIMD:
    compute divides across VPU lanes.  ``@stream`` loops are the pallas
    grid: sequential on one core with double-buffered DMA (memory
    overlapped with compute across steps).
    """
    mod = _as_hw(x, m)

    def go(nodes: List[HwCtrl], lanes: int, scope: HwModule) -> Dict[str, float]:
        acc = {"compute": 0.0, "memory": 0.0, "control": 0.0}
        for n in nodes:
            if isinstance(n, HwLoop):
                if n.kind == "fsm":
                    body = go(n.body, lanes, scope)
                    acc["compute"] += body["compute"] * n.trips
                    acc["memory"] += body["memory"] * n.trips
                    acc["control"] += (m.loop_setup_cycles +
                                       body["control"] * n.trips +
                                       m.seq_loop_overhead_cycles * n.trips)
                elif n.kind == "unroll":
                    body = go(n.body, lanes, scope)
                    acc["compute"] += body["compute"] * n.trips
                    acc["memory"] += body["memory"] * n.trips
                    acc["control"] += (m.loop_setup_cycles +
                                       body["control"] * n.trips)
                elif n.kind == "simd":
                    body = go(n.body, lanes * n.trips, scope)
                    acc["compute"] += body["compute"] * n.trips
                    acc["memory"] += body["memory"] * n.trips
                    acc["control"] += (m.loop_setup_cycles +
                                       body["control"] * n.trips)
                elif n.kind == "stream":
                    body = go(n.body, lanes, scope)
                    # double-buffered: memory overlaps compute across steps
                    comp = body["compute"] * n.trips
                    mem = body["memory"] * n.trips
                    acc["compute"] += max(comp, mem)    # overlap: pay the max
                    acc["control"] += (m.loop_setup_cycles +
                                       body["control"] * n.trips +
                                       m.seq_loop_overhead_cycles * n.trips)
                else:
                    raise ValueError(n.kind)
            elif isinstance(n, hw_ir.HwInstance):
                sub = scope.submodule(n.module)
                body = go(sub.ctrl, lanes, sub)
                acc["compute"] += body["compute"]
                acc["memory"] += body["memory"]
                acc["control"] += body["control"] + m.call_overhead_cycles
            else:
                c = step_cycles(n, scope, m, lanes)
                acc["compute"] += c["compute"]
                acc["memory"] += c["memory"]
                acc["control"] += c.get("control", 0.0)
        return acc

    a = go(mod.ctrl, 1, mod)
    total = int(round(a["compute"] + a["memory"] + a["control"]))
    return CycleReport(total=total, compute=int(round(a["compute"])),
                       memory=int(round(a["memory"])),
                       control=int(round(a["control"])))


# --------------------------------------------------------------------------
# Resource model (Fig. 3 analogue) — reads the module structure
# --------------------------------------------------------------------------


def resources(x: HwLike, m: MachineModel = TPU_V5E) -> ResourceReport:
    """Spatial resources of the hardware module.

    The datapath under an ``@fsm``/``@stream`` loop is instantiated
    *once* and reused each trip (paper: "time division multiplexing,
    allowing the reuse of data paths and DSPs"); under ``@unroll`` /
    ``@simd`` its units carry ``copies`` = the replication product
    (paper: "hardware consumption is directly proportional to the size
    of matrix").  Lane and RAM totals are read straight off the
    declarations; live register tiles walk the control tree because a
    register bank replicated with its datapath counts once per copy.
    """
    mod = _as_hw(x, m)

    vmem = mod.mem_bytes()
    if vmem > m.vmem_capacity_bytes:
        raise ResourceWarning(
            f"module {mod.name} RAM footprint {vmem} exceeds "
            f"capacity {m.vmem_capacity_bytes}")
    return ResourceReport(compute_lanes=mod.lane_count(), vmem_bytes=vmem,
                          vreg_tiles=_max_vregs(mod),
                          fsm_states=mod.fsm_state_count(),
                          reg_bits=mod.register_bits(),
                          total_lanes=mod.total_lanes(),
                          mux_bits=mod.mux_bits(),
                          shared_units=mod.shared_unit_count())


def _max_vregs(mod: HwModule) -> int:
    """Peak live register tiles; instance port maps pin their operands
    live across the whole call, and each submodule's own peak counts."""
    reg_names = {r.name for r in mod.regs}
    best = 0
    for node, _, trail in mod.walk():
        if isinstance(node, HwStep):
            operands = node.operands
        elif isinstance(node, hw_ir.HwInstance):
            operands = node.portmap
        else:
            continue
        rep = 1
        for loop in trail:
            if loop.kind in ("unroll", "simd"):
                rep *= loop.trips
        live = sum(1 for o in operands if o.target in reg_names)
        best = max(best, live * rep)
    for sub in mod.submodules:
        best = max(best, _max_vregs(sub))
    return best


# --------------------------------------------------------------------------
# FLOP / byte accounting used by roofline math elsewhere (workload-side,
# so it stays on LoopIR)
# --------------------------------------------------------------------------


def flops(kernel: Kernel) -> int:
    total = 0
    for s, _, trail in kernel.walk():
        if isinstance(s, Loop):
            continue
        trip = 1
        for loop in trail:
            trip *= loop.var.extent
        if isinstance(s, MatmulTile):
            total += 2 * s.macs * trip
        else:
            total += s.dst.tile_elems * trip
    return total


def hbm_bytes(kernel: Kernel) -> int:
    """Bytes moved between HBM and on-chip storage (once per touch)."""
    from .loop_ir import _stmt_refs

    total = 0
    for s, _, trail in kernel.walk():
        if isinstance(s, Loop):
            continue
        trip = 1
        for loop in trail:
            trip *= loop.var.extent
        for ref in _stmt_refs(s):
            if ref.buffer.space == MemSpace.HBM:
                total += ref.tile_bytes * trip
    return total
