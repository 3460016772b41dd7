"""HwSim — cycle-accurate simulation of HwIR modules (the Vivado-sim role).

The paper validates its generated RTL two ways: numerically ("accurate
output matrices") and temporally (consumed clock cycles read off Vivado
simulation).  This module gives the reproduction's hardware level the
same property: an :class:`~repro_torch.core.hw_ir.HwModule` *executes* against
real numpy inputs, and the run yields an **observed** cycle count that
can be cross-checked against the analytic ``machine_model.cycles``
prediction.

The interpreter walks the control tree exactly as the hardware would
sequence it:

  * ``@fsm`` / ``@stream`` loops step a counter register through their
    trips, paying the FSM state-transition chain each iteration;
  * ``@unroll`` / ``@simd`` bodies are spatially replicated — every copy
    executes (numerics are computed per replication index) but control
    is paid once, and ``@simd`` divides compute across VPU lanes;
  * each :class:`~repro_torch.core.hw_ir.HwStep` invokes its datapath unit:
    the operand address generators (affine ``index`` over the enclosing
    counters) resolve to numpy slices of the port/mem/reg backing
    arrays, and the invocation is charged its unit latency.

Per-event latencies come from :func:`machine_model.step_cycles` — one
source of truth for unit timing, so model and simulation can only
diverge through *scheduling* effects (e.g. the double-buffered DMA
overlap of ``@stream`` loops, replayed here event-by-event), never
through inconsistent constants.  Fractional per-event cycles represent
pipelined initiation intervals; totals are rounded once at the end,
mirroring the analytic report.

``simulate`` runs a bare module; ``cosim`` additionally checks the
outputs against the LoopIR numpy oracle (``backend_ref``) and packages
observed-vs-modeled cycles.  The host-coupled transaction model (CSR +
crossbar DMA) lives in :mod:`repro_torch.core.host_bridge`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import backend_ref, machine_model
from .backend_ref import _EWISE_NP, _np_dtype, reduce_tile_np, scan_tile_np
from .hw_ir import HwInstance, HwLoop, HwModule, HwOperand, HwStep
from .loop_ir import Kernel
from .machine_model import TPU_V5E, CycleReport, MachineModel


class SimError(RuntimeError):
    """Simulation could not run (bad inputs, inexecutable op, runaway)."""


class SimMismatch(SimError):
    """Co-simulation numeric mismatch against the reference backend."""


# --------------------------------------------------------------------------
# reports
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One retired event of the simulated schedule."""

    cycle: int                       # observed cycle at retirement
    kind: str                        # "step" | "loop" | "dma" | "call" | "done"
    label: str                       # state-ish label (unit.op / %counter)
    detail: str = ""
    env: Tuple[Tuple[str, int], ...] = ()   # counter bindings, sorted
    seq: int = 0                     # dynamic event ordinal

    def __str__(self):
        binds = " ".join(f"{c}={v}" for c, v in self.env)
        parts = [f"[{self.cycle:>10,}]", f"{self.kind:<4}", self.label]
        if binds:
            parts.append(f"({binds})")
        if self.detail:
            parts.append(f"  // {self.detail}")
        return " ".join(parts)


@dataclasses.dataclass
class SimReport:
    """Result of one module simulation: final storage state + observed
    cycle accounting + (optionally) the per-state event trace."""

    module: str
    storage: Dict[str, np.ndarray]   # final contents of every declaration
    out_ports: List[str]             # ports with direction out/inout
    cycles: CycleReport              # observed (event-accumulated)
    steps_retired: int
    fsm_transitions: int             # dynamic state transitions taken
    counters: List[str]              # sequenced-loop counter names
    trace: List[TraceEvent] = dataclasses.field(default_factory=list)
    trace_truncated: bool = False

    @property
    def outputs(self) -> List[np.ndarray]:
        """Contents of the write-channel ports, in port order."""
        return [self.storage[n] for n in self.out_ports]

    def summary(self) -> str:
        return (f"sim {self.module}: {self.cycles}, "
                f"steps={self.steps_retired:,}, "
                f"fsm_transitions={self.fsm_transitions:,}")

    def format_trace(self) -> str:
        lines = [f"// trace of {self.module}: {len(self.trace)} events"]
        lines += [str(ev) for ev in self.trace]
        if self.trace_truncated:
            lines.append("// ... trace truncated (max events reached)")
        return "\n".join(lines)

    def vcd(self) -> str:
        """VCD-style dump of the schedule: the dynamic step ordinal and
        every sequenced-loop counter, one timestamp per retired event.
        Toy-scale (readable in GTKWave), not a full four-state dump."""
        names = ["step"] + list(self.counters)
        sym = {n: chr(33 + i) for i, n in enumerate(names)}
        lines = [
            "$date stagecc hw_sim $end",
            "$timescale 1ns $end",
            f"$scope module {self.module} $end",
        ]
        for n in names:
            lines.append(f"$var wire 32 {sym[n]} {n} $end")
        lines.append("$upscope $end")
        lines.append("$enddefinitions $end")
        lines.append("#0")
        for n in names:
            lines.append(f"b0 {sym[n]}")
        # VCD requires strictly ascending timestamps; trace cycles can
        # step back when a @stream loop reclaims overlap credit at its
        # close, so clamp each emission to be monotone
        t = 0
        for ev in self.trace:
            if ev.kind not in ("step", "loop"):
                continue
            t = max(t + 1, ev.cycle)
            lines.append(f"#{t}")
            lines.append(f"b{ev.seq:b} {sym['step']}")
            for c, v in ev.env:
                if c in sym:
                    lines.append(f"b{v:b} {sym[c]}")
        lines.append(f"#{max(t + 1, self.cycles.total)}")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class CoSimReport:
    """Observed-vs-modeled packaging of one co-simulation run."""

    sim: SimReport
    modeled_cycles: int
    observed_cycles: int
    checked: bool = False            # outputs compared against the oracle
    max_abs_err: float = float("nan")

    @property
    def outputs(self) -> List[np.ndarray]:
        return self.sim.outputs

    @property
    def cycle_ratio(self) -> float:
        return self.observed_cycles / max(1, self.modeled_cycles)

    def summary(self) -> str:
        s = (f"cosim {self.sim.module}: observed={self.observed_cycles:,} "
             f"cycles vs modeled={self.modeled_cycles:,} "
             f"(ratio {self.cycle_ratio:.4f}), "
             f"steps={self.sim.steps_retired:,}, "
             f"fsm_transitions={self.sim.fsm_transitions:,}")
        if self.checked:
            s += f", max|err|={self.max_abs_err:.1e} vs numpy oracle"
        return s


# --------------------------------------------------------------------------
# the interpreter
# --------------------------------------------------------------------------


class _Sim:
    def __init__(self, mod: HwModule, machine: MachineModel, trace: bool,
                 max_trace_events: int, max_steps: int):
        self.mod = mod
        self.m = machine
        self.want_trace = trace
        self.max_trace_events = max_trace_events
        self.max_steps = max_steps
        self.mem: Dict[str, np.ndarray] = {}
        self.clock = 0.0                 # observed cycle estimate
        self.steps = 0
        self.transitions = 0
        self.seq = 0
        self.trace: List[TraceEvent] = []
        self.trace_truncated = False

    # ---- storage ----------------------------------------------------------

    def bind(self, inputs: Sequence[np.ndarray]) -> None:
        inputs = list(inputs)
        it = iter(inputs)
        in_ports = [p for p in self.mod.ports if p.direction == "in"]
        if len(inputs) > len(in_ports):
            raise SimError(
                f"module {self.mod.name} has {len(in_ports)} input ports "
                f"but {len(inputs)} inputs were given")
        for p in self.mod.ports:
            dt = _np_dtype(p.dtype)
            if p.direction == "in":
                try:
                    a = np.asarray(next(it))
                except StopIteration:
                    # unbound input channel (HBM temporary): reads zeros
                    self.mem[p.name] = np.zeros(p.shape, dt)
                    continue
                if tuple(a.shape) != tuple(p.shape):
                    raise SimError(f"port {p.name}: input shape {a.shape} "
                                   f"!= {p.shape}")
                self.mem[p.name] = np.array(a, dtype=dt)
            else:
                # write channels start zeroed, like the oracle's outputs
                self.mem[p.name] = np.zeros(p.shape, dt)
        for r in self.mod.regs:
            self.mem[r.name] = np.zeros(r.shape, _np_dtype(r.dtype))
        for mm in self.mod.mems:
            self.mem[mm.name] = np.zeros(mm.shape, _np_dtype(mm.dtype))

    # ---- tracing ----------------------------------------------------------

    def _emit(self, kind: str, label: str, env: Dict[str, int],
              detail: str = "") -> None:
        if not self.want_trace:
            return
        if len(self.trace) >= self.max_trace_events:
            self.trace_truncated = True
            return
        self.seq += 1
        self.trace.append(TraceEvent(
            cycle=int(round(self.clock)), kind=kind, label=label,
            detail=detail, env=tuple(sorted(env.items())), seq=self.seq))

    # ---- execution --------------------------------------------------------

    def _slices(self, o: HwOperand, env: Dict[str, int]) -> Tuple[slice, ...]:
        shape = tuple(self.mod.storage(o.target).shape)
        return o.slices(shape, env)

    def _get(self, o: HwOperand, env: Dict[str, int]) -> np.ndarray:
        return self.mem[o.target][self._slices(o, env)]

    def _put(self, o: HwOperand, env: Dict[str, int], val) -> None:
        self.mem[o.target][self._slices(o, env)] = val

    def _exec_step(self, step: HwStep, env: Dict[str, int]) -> None:
        ops = step.operands
        if step.op == "zero":
            self._put(ops[0], env, 0.0)
        elif step.op == "ones":
            self._put(ops[0], env, 1.0)
        elif step.op == "fill_min":
            self._put(ops[0], env, -1e30)
        elif step.op in ("reduce_max", "reduce_sum"):
            dst, src = ops
            # shares the oracle's numpy expression so cosim is bitwise
            self._put(dst, env, reduce_tile_np(
                step.op[len("reduce_"):], self._get(dst, env),
                self._get(src, env), dst.role == "acc"))
        elif step.op in ("scan_linear", "scan_cumsum"):
            dst, carry = ops[0], ops[1]
            srcs = [self._get(o, env) for o in ops[2:]]
            out = scan_tile_np(step.op[len("scan_"):], srcs,
                               self._get(carry, env))
            self._put(dst, env, out)
            self._put(carry, env, out[-1:])
        elif step.op == "matmul":
            dst, lhs, rhs = ops
            c = (self._get(lhs, env).astype(np.float32)
                 @ self._get(rhs, env).astype(np.float32))
            if dst.role == "acc":
                c = self._get(dst, env) + c
            self._put(dst, env, c)
        else:
            dst, srcs = ops[0], [self._get(o, env) for o in ops[1:]]
            if step.op == "copy1":
                shape = self.mem[dst.target][self._slices(dst, env)].shape
                self._put(dst, env, srcs[0].reshape(shape))
            elif step.op == "cast":
                self._put(dst, env, srcs[0])   # numpy casts on assignment
            else:
                fn = _EWISE_NP.get(step.op)
                if fn is None:
                    raise SimError(f"step op {step.op!r} has no executable "
                                   f"semantics on unit {step.unit}")
                # broadcast rank-1 bias against rank-n tiles, as the
                # oracle does
                if len(srcs) == 2 and srcs[1].ndim < srcs[0].ndim:
                    srcs[1] = srcs[1][(None,) * (srcs[0].ndim - srcs[1].ndim)]
                self._put(dst, env, fn(*srcs))

    def run_block(self, nodes, env: Dict[str, int],
                  lanes: int) -> Dict[str, float]:
        acc = {"compute": 0.0, "memory": 0.0, "control": 0.0}
        for n in nodes:
            if isinstance(n, HwLoop):
                acc["control"] += self.m.loop_setup_cycles
                self.clock += self.m.loop_setup_cycles
                if n.kind in ("fsm", "stream"):
                    sub = {"compute": 0.0, "memory": 0.0, "control": 0.0}
                    for t in range(n.trips):
                        # the loop header state: test + counter increment
                        sub["control"] += self.m.seq_loop_overhead_cycles
                        self.clock += self.m.seq_loop_overhead_cycles
                        self.transitions += 1
                        self._emit("loop", f"%{n.counter}",
                                   {**env, n.counter: t},
                                   f"@{n.kind} trip {t}/{n.trips}")
                        body = self.run_block(n.body, {**env, n.counter: t},
                                              lanes)
                        for k in sub:
                            sub[k] += body[k]
                    if n.kind == "stream":
                        # double-buffered DMA: the grid sequencer overlaps
                        # the body's memory traffic with compute across
                        # steps; the engines run concurrently, so the
                        # loop's wall-clock is the busier of the two.
                        overlapped = max(sub["compute"], sub["memory"])
                        credit = (sub["compute"] + sub["memory"]
                                  - overlapped)
                        if credit > 0:
                            self.clock -= credit
                            self._emit("dma", f"%{n.counter}", env,
                                       f"stream overlap reclaimed "
                                       f"{credit:.1f} cycles")
                        sub = {"compute": overlapped, "memory": 0.0,
                               "control": sub["control"]}
                    for k in acc:
                        acc[k] += sub[k]
                else:
                    # unroll/simd: spatial replication — every copy
                    # computes (distinct replication index), control is
                    # paid once and no per-trip FSM transition exists
                    sub_lanes = lanes * n.trips if n.kind == "simd" else lanes
                    for t in range(n.trips):
                        self._emit("loop", f"%{n.counter}",
                                   {**env, n.counter: t},
                                   f"@{n.kind} copy {t}/{n.trips}")
                        body = self.run_block(n.body, {**env, n.counter: t},
                                              sub_lanes)
                        for k in acc:
                            acc[k] += body[k]
            elif isinstance(n, HwInstance):
                sub = self.mod.submodule(n.module)
                # port map: each submodule port becomes a numpy *view* of
                # the caller's storage slice, so writes land in place —
                # exactly one physical memory, accessed through the
                # instance's address map.  Local regs/mems reset per call.
                submem: Dict[str, np.ndarray] = {}
                for port, o in zip(sub.ports, n.portmap):
                    submem[port.name] = self.mem[o.target][
                        self._slices(o, env)]
                for r in sub.regs:
                    submem[r.name] = np.zeros(r.shape, _np_dtype(r.dtype))
                for mm in sub.mems:
                    submem[mm.name] = np.zeros(mm.shape, _np_dtype(mm.dtype))
                saved = (self.mod, self.mem)
                self.mod, self.mem = sub, submem
                try:
                    body = self.run_block(sub.ctrl, {}, lanes)
                finally:
                    self.mod, self.mem = saved
                for k in acc:
                    acc[k] += body[k]
                # start/done handshake of the call-site FSM state
                acc["control"] += self.m.call_overhead_cycles
                self.clock += self.m.call_overhead_cycles
                self.transitions += 1
                opnds = ",".join(o.target for o in n.portmap)
                self._emit("call", f"@{n.module}", env, f"({opnds})")
            else:
                self.steps += 1
                if self.steps > self.max_steps:
                    raise SimError(
                        f"simulation exceeded {self.max_steps:,} dynamic "
                        f"steps (runaway schedule?)")
                try:
                    self._exec_step(n, env)
                except IndexError as e:
                    # verify() bounds the whole iteration box, so this is
                    # a belt-and-braces escape hatch for hand-built
                    # modules that bypassed it
                    raise SimError(
                        f"address generator overran storage: {e}") from e
                c = machine_model.step_cycles(n, self.mod, self.m, lanes)
                acc["compute"] += c["compute"]
                acc["memory"] += c["memory"]
                # contention stall of a serialized shared-unit binding —
                # same formula the analytic model charges
                acc["control"] += c.get("control", 0.0)
                self.clock += (c["compute"] + c["memory"]
                               + c.get("control", 0.0))
                self.transitions += 1
                opnds = ",".join(o.target for o in n.operands)
                self._emit("step", f"{n.unit}.{n.op}", env, f"({opnds})")
        return acc


def simulate(mod: HwModule, inputs: Sequence[np.ndarray] = (),
             machine: MachineModel = TPU_V5E, trace: bool = False,
             max_trace_events: int = 65536,
             max_steps: int = 10_000_000) -> SimReport:
    """Execute ``mod`` cycle-accurately against ``inputs``.

    ``inputs`` bind the module's ``in``-direction ports in declaration
    order (missing trailing inputs read zeros — HBM temporaries); all
    write-channel ports, register banks and RAMs start zeroed.  Returns
    a :class:`SimReport` with the final storage state, the observed
    cycle accounting, and (when ``trace``) the retired-event trace.
    """
    mod.verify()
    sim = _Sim(mod, machine, trace, max_trace_events, max_steps)
    sim.bind(inputs)
    costs = sim.run_block(mod.ctrl, {}, 1)
    sim._emit("done", "S_IDLE", {}, "machine returned to idle")
    total = int(round(costs["compute"] + costs["memory"] + costs["control"]))
    report = CycleReport(total=total,
                         compute=int(round(costs["compute"])),
                         memory=int(round(costs["memory"])),
                         control=int(round(costs["control"])))
    return SimReport(
        module=mod.name, storage=sim.mem,
        out_ports=[p.name for p in mod.ports
                   if p.direction in ("out", "inout")],
        cycles=report, steps_retired=sim.steps,
        fsm_transitions=sim.transitions,
        counters=[l.counter for l in mod.loops()
                  if l.kind in ("fsm", "stream")],
        trace=sim.trace, trace_truncated=sim.trace_truncated)


# --------------------------------------------------------------------------
# co-simulation against the LoopIR oracle
# --------------------------------------------------------------------------


def random_inputs(mod: HwModule, seed: int = 0) -> List[np.ndarray]:
    """Deterministic random arrays for the module's input ports."""
    rng = np.random.default_rng(seed)
    out = []
    for p in mod.ports:
        if p.direction != "in":
            continue
        out.append(np.asarray(rng.standard_normal(p.shape),
                              dtype=_np_dtype(p.dtype)))
    return out


def cosim(mod: HwModule, kernel: Optional[Kernel],
          inputs: Sequence[np.ndarray], machine: MachineModel = TPU_V5E,
          modeled: Optional[int] = None, trace: bool = False,
          check: bool = True, atol: float = 1e-5) -> CoSimReport:
    """Simulate ``mod`` and cross-check it both ways:

    * numerically — final output-port contents against the LoopIR numpy
      oracle (``backend_ref.run(kernel, inputs)``), when a kernel is
      available;
    * temporally — observed cycles against the analytic
      ``machine_model.cycles`` prediction (``modeled`` overrides).

    Raises :class:`SimMismatch` when any output deviates beyond ``atol``.
    """
    rep = simulate(mod, inputs, machine=machine, trace=trace)
    if modeled is None:
        modeled = machine_model.cycles(mod, machine).total
    checked, max_err = False, float("nan")
    if check and kernel is not None:
        refs = backend_ref.run(kernel, inputs)
        max_err = 0.0
        for buf, want in zip(kernel.outputs, refs):
            got = rep.storage[buf.name]
            err = float(np.max(np.abs(np.asarray(got, dtype=np.float64)
                                      - np.asarray(want,
                                                   dtype=np.float64))))
            max_err = max(max_err, err)
            if err > atol:
                raise SimMismatch(
                    f"co-sim mismatch on output {buf.name!r}: "
                    f"max|err|={err:.3e} > atol={atol:g}")
        checked = True
    return CoSimReport(sim=rep, modeled_cycles=modeled,
                       observed_cycles=rep.cycles.total,
                       checked=checked, max_abs_err=max_err)
