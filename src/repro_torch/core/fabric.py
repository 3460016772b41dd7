"""Multi-kernel fabric — N accelerators behind one shared crossbar.

The paper's end state couples *one* generated hardware module to the
host CPU over a vendor crossbar; ``host_bridge.run_transaction`` models
exactly that single transaction.  This module generalizes the coupling
to a **fabric**: N :class:`~repro_torch.core.hw_ir.HwModule` instances (the
*slots*) share one :class:`~repro_torch.core.host_bridge.Crossbar`, each with
its own command/DMA queue, and a host-side scheduler dispatches a
request stream across them — overlapping one kernel's DMA with
another's compute, with the shared crossbar arbitrated **per beat** so
overlapping bursts are serialized honestly instead of priced
independently.

Pricing symmetry (model and simulator, fabric-scale): there is exactly
ONE scheduling core, :func:`Fabric._schedule` — an event-driven simulation
of slots + crossbar + host queues.  The **fabric machine model**
(:meth:`Fabric.model`) feeds it analytic per-kernel device cycles from
``machine_model.cycles``; the **fabric event simulator**
(:meth:`Fabric.simulate`) feeds it *observed* device cycles from
``hw_sim.simulate`` (each distinct module executed once, outputs
checked against the numpy oracle when a LoopIR kernel is attached).
Both sides price DMA, CSR and arbitration with the same arithmetic as
``host_bridge.run_transaction`` — a one-slot, one-request fabric
reproduces that transaction's cycle count exactly (pinned by test).

Arbitration policies:

  * ``round_robin`` — per-beat round-robin over the active bursts:
    with n bursts in flight each progresses at 1/n beats per cycle
    (deterministic processor sharing — the limit of per-beat RR);
  * ``priority``    — strict preemptive priority (lower slot
    ``priority`` value wins the crossbar; equal priorities fall back
    to round-robin among themselves).

The **serialized baseline** (``overlap=False``) runs the same core with
a global one-transaction-at-a-time lock — exactly back-to-back
``run_transaction`` calls, the seed behaviour every BENCH_fabric entry
must beat.

Fleet-level DSE: :func:`explore_fleet` composes per-kernel
``dse.explore`` frontiers into fleet candidates (which schedule each
kernel gets, how many copies) under a total
:class:`~repro_torch.core.dse.ResourceBudget`, prices each fleet with the
fabric machine model against a :class:`TrafficMix`, ranks candidates on
a throughput-under-contention × total-area Pareto frontier, and
validates the top points with the fabric event simulator (model vs
simulated requests/s within a tolerance — the same modeled-vs-observed
gate ``dse.validate_point`` applies per kernel).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import dse as dse_mod
from . import hw_sim, machine_model
from .host_bridge import AXI4, Crossbar, port_bytes
from .hw_ir import HwModule
from .loop_ir import Kernel
from .machine_model import TPU_V5E, MachineModel
from .tensor_ir import Graph

ARBITRATION_POLICIES = ("round_robin", "priority")

_EPS = 1e-6


# --------------------------------------------------------------------------
# per-transaction cost breakdown (host_bridge arithmetic, reused)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransactionCost:
    """Phase costs of one request on one slot, in device-clock cycles.

    Mirrors ``host_bridge.run_transaction`` exactly: ``csr_setup`` two
    CSR writes per port, ``dma_in``/``dma_out`` one burst per port
    (handshake latency + one cycle per data beat), ``start`` one CSR
    write, ``poll`` the done-bit quantisation + per-poll CSR reads +
    the CYCLES readback.  The DMA phases are the *contended* ones: on
    the fabric their cycles are crossbar beats that arbitrate against
    other slots' bursts.
    """

    csr_setup: int
    dma_in: int
    start: int
    device: int
    poll: int
    dma_out: int

    @property
    def total(self) -> int:
        return (self.csr_setup + self.dma_in + self.start + self.device
                + self.poll + self.dma_out)


def transaction_cost(mod: HwModule, crossbar: Crossbar, device_cycles: int,
                     poll_interval: int = 64) -> TransactionCost:
    """The fabric's pricing of one request — term-for-term the phase
    arithmetic of ``host_bridge.run_transaction`` (pinned by test)."""
    csr = crossbar.csr_access_cycles
    setup = 2 * len(mod.ports) * csr
    dma_in = sum(crossbar.dma_cycles(port_bytes(p)) for p in mod.ports
                 if p.direction == "in")
    dma_out = sum(crossbar.dma_cycles(port_bytes(p)) for p in mod.ports
                  if p.direction in ("out", "inout"))
    polls = max(1, math.ceil(device_cycles / max(1, poll_interval)))
    wait = polls * poll_interval - device_cycles
    poll = wait + polls * csr + csr          # + the CYCLES readback
    return TransactionCost(csr_setup=setup, dma_in=dma_in, start=csr,
                           device=device_cycles, poll=poll, dma_out=dma_out)


# --------------------------------------------------------------------------
# requests and traffic mixes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FabricRequest:
    """One dispatchable request: run kernel ``kernel`` once, arriving at
    ``arrival`` device-clock cycles after stream start."""

    rid: int
    kernel: str
    arrival: float


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """A fabric workload: arrival process (``serve.loadgen`` reuse) ×
    per-kernel dispatch weights.

    Arrival times come from :func:`repro_torch.serve.loadgen.generate_stream`
    (Poisson / bursty / uniform, replayable seed) in abstract time
    units; ``cycles_per_unit`` converts them to device-clock cycles.
    Each request's target kernel is drawn from ``weights`` by the same
    seeded generator, so the whole stream is a pure function of the mix.
    """

    name: str
    weights: Tuple[Tuple[str, float], ...]    # (kernel name, weight)
    num_requests: int = 32
    process: str = "poisson"                  # poisson | bursty | uniform
    rate: float = 1.0                         # arrivals per time unit
    cycles_per_unit: float = 1.0
    seed: int = 0

    def describe(self) -> Dict:
        return {"name": self.name, "weights": dict(self.weights),
                "num_requests": self.num_requests, "process": self.process,
                "rate": self.rate, "cycles_per_unit": self.cycles_per_unit,
                "seed": self.seed}


def fabric_stream(mix: TrafficMix) -> List[FabricRequest]:
    """The deterministic request stream of ``mix`` (loadgen arrivals,
    seeded kernel draws, arrival units scaled to cycles)."""
    from repro_torch.serve import loadgen

    load = loadgen.LoadConfig(num_requests=mix.num_requests, seed=mix.seed,
                              process=mix.process, rate=mix.rate)
    arrivals = [r.arrival for r in loadgen.generate_stream(load)]
    names = [k for k, _ in mix.weights]
    w = np.asarray([w for _, w in mix.weights], dtype=np.float64)
    if not len(names) or np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"mix {mix.name!r}: weights must be non-empty "
                         f"and non-negative with positive sum")
    rng = np.random.default_rng(mix.seed + 0x5EED)
    picks = rng.choice(len(names), size=mix.num_requests, p=w / w.sum())
    return [FabricRequest(rid=i, kernel=names[int(picks[i])],
                          arrival=float(a * mix.cycles_per_unit))
            for i, a in enumerate(arrivals)]


def saturating_cycles_per_unit(mix: TrafficMix, mean_service_cycles: float,
                               load_factor: float = 2.0) -> float:
    """``cycles_per_unit`` that offers ``load_factor`` × one device's
    capacity: offered rate (req/cycle) = rate / cycles_per_unit, one
    serialized device serves 1/mean_service_cycles — a fabric only shows
    its contention behaviour when the stream actually queues."""
    if mean_service_cycles <= 0 or load_factor <= 0:
        raise ValueError("mean_service_cycles and load_factor must be > 0")
    return mix.rate * mean_service_cycles / load_factor


# --------------------------------------------------------------------------
# the fabric
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FabricSlot:
    """One accelerator instance on the fabric."""

    name: str                         # instance name, e.g. "gemm8#0"
    kernel_name: str                  # dispatch key requests name
    module: HwModule
    kernel: Optional[Kernel] = None   # LoopIR stage: numeric oracle for sim
    priority: int = 0                 # lower wins under the priority policy


class FabricError(RuntimeError):
    """Fabric construction or scheduling failed."""


@dataclasses.dataclass
class _SlotState:
    """Mutable per-slot scheduling state (one request in flight max)."""

    queue: List[FabricRequest] = dataclasses.field(default_factory=list)
    current: Optional[FabricRequest] = None
    phase: int = -1                   # index into _PHASES
    phase_end: float = 0.0            # fixed-duration phases
    dma_remaining: float = 0.0        # crossbar phases
    busy_cycles: float = 0.0
    completed: int = 0


#: phase order of one request; "xbar" phases contend on the crossbar,
#: "slot" phases occupy only the slot's own command channel / datapath
_PHASES = (("csr_setup", "slot"), ("dma_in", "xbar"), ("start", "slot"),
           ("device", "slot"), ("poll", "slot"), ("dma_out", "xbar"))


@dataclasses.dataclass
class FabricReport:
    """One scheduled run of a request stream over the fabric."""

    mode: str                         # "overlap" | "serialized"
    policy: str
    device_source: str                # "model" | "sim"
    crossbar: Crossbar
    requests: int
    completed: int
    total_cycles: int                 # makespan: last completion
    requests_per_s: float
    crossbar_busy_cycles: int
    crossbar_utilization: float
    latency_cycles: Dict[str, float]  # StreamingHistogram summary
    slots: List[Dict]                 # per-slot accounting
    device_cycles: Dict[str, int]     # per-slot device cycles fed in
    checked: bool = False             # sim outputs compared to the oracle
    max_abs_err: float = float("nan")
    transcript: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "mode": self.mode, "policy": self.policy,
            "device_source": self.device_source,
            "crossbar": {"name": self.crossbar.name,
                         "data_width_bits": self.crossbar.data_width_bits,
                         "latency_cycles": self.crossbar.latency_cycles},
            "requests": self.requests, "completed": self.completed,
            "total_cycles": self.total_cycles,
            "requests_per_s": round(self.requests_per_s, 3),
            "crossbar_busy_cycles": self.crossbar_busy_cycles,
            "crossbar_utilization": round(self.crossbar_utilization, 4),
            "latency_cycles": self.latency_cycles,
            "slots": self.slots,
            "device_cycles": self.device_cycles,
        }

    def summary(self) -> str:
        lines = [f"fabric [{self.mode}/{self.policy}] "
                 f"({self.device_source} device cycles): "
                 f"{self.completed}/{self.requests} requests in "
                 f"{self.total_cycles:,} cycles "
                 f"-> {self.requests_per_s:,.1f} req/s, "
                 f"crossbar util {self.crossbar_utilization:.1%}"]
        for s in self.slots:
            q = s["queue_depth"]
            lines.append(
                f"  {s['name']:<14} {s['kernel']:<10} "
                f"served={s['completed']:<4} "
                f"busy={s['busy_cycles']:>10,} cyc "
                f"({s['utilization']:.1%})  "
                f"queue p50/p99={q['p50']:.0f}/{q['p99']:.0f}")
        if self.checked:
            lines.append(f"  numeric check vs numpy oracle: "
                         f"max|err|={self.max_abs_err:.1e}")
        return "\n".join(lines)


@dataclasses.dataclass
class Fabric:
    """N accelerator slots behind one shared crossbar."""

    slots: List[FabricSlot]
    crossbar: Crossbar = AXI4
    policy: str = "round_robin"
    poll_interval: int = 64

    def __post_init__(self):
        if not self.slots:
            raise FabricError("a fabric needs at least one slot")
        if self.policy not in ARBITRATION_POLICIES:
            raise FabricError(
                f"unknown arbitration policy {self.policy!r}; choose from "
                f"{', '.join(ARBITRATION_POLICIES)}")
        names = [s.name for s in self.slots]
        if len(set(names)) != len(names):
            raise FabricError(f"duplicate slot names: {names}")

    # ---- the two symmetric entry points -----------------------------------

    def model(self, stream: Sequence[FabricRequest],
              machine: MachineModel = TPU_V5E, overlap: bool = True,
              transcript: bool = False) -> FabricReport:
        """Fabric machine model: schedule ``stream`` with *analytic*
        per-kernel device cycles (``machine_model.cycles``)."""
        dev = {s.name: machine_model.cycles(s.module, machine).total
               for s in self.slots}
        return self._schedule(stream, dev, machine, overlap=overlap,
                              source="model", transcript=transcript)

    def simulate(self, stream: Sequence[FabricRequest],
                 machine: MachineModel = TPU_V5E, overlap: bool = True,
                 seed: int = 0, check: bool = True,
                 atol: float = 1e-5,
                 transcript: bool = False) -> FabricReport:
        """Fabric event simulator: schedule ``stream`` with *observed*
        device cycles from ``hw_sim.simulate`` — each distinct module
        executed once on seeded inputs, outputs checked against the
        numpy oracle when the slot carries its LoopIR kernel.  The
        scheduling core is byte-identical to :meth:`model`; only the
        device-cycle source differs (the model/simulator symmetry).
        """
        from . import backend_ref

        dev: Dict[str, int] = {}
        cache: Dict[int, Tuple[int, float, bool]] = {}
        max_err, checked_any = 0.0, False
        for s in self.slots:
            key = id(s.module)
            if key not in cache:
                inputs = hw_sim.random_inputs(s.module, seed=seed)
                rep = hw_sim.simulate(s.module, inputs, machine=machine)
                err, did = float("nan"), False
                if check and s.kernel is not None:
                    refs = backend_ref.run(s.kernel, inputs)
                    err = 0.0
                    for buf, want in zip(s.kernel.outputs, refs):
                        got = rep.storage[buf.name]
                        err = max(err, float(np.max(np.abs(
                            np.asarray(got, np.float64)
                            - np.asarray(want, np.float64)))))
                    if err > atol:
                        raise hw_sim.SimMismatch(
                            f"fabric slot {s.name}: simulated outputs "
                            f"deviate from the numpy oracle by {err:.3e} "
                            f"(> atol={atol:g})")
                    did = True
                cache[key] = (rep.cycles.total, err, did)
            cyc, err, did = cache[key]
            dev[s.name] = cyc
            if did:
                checked_any = True
                max_err = max(max_err, err)
        out = self._schedule(stream, dev, machine, overlap=overlap,
                             source="sim", transcript=transcript)
        out.checked = checked_any
        out.max_abs_err = max_err if checked_any else float("nan")
        return out

    # ---- the one scheduling core ------------------------------------------

    def _costs(self, dev: Dict[str, int]) -> List[TransactionCost]:
        return [transaction_cost(s.module, self.crossbar, dev[s.name],
                                 self.poll_interval) for s in self.slots]

    def _schedule(self, stream: Sequence[FabricRequest],
                  device_cycles: Dict[str, int], machine: MachineModel,
                  overlap: bool, source: str,
                  transcript: bool = False) -> FabricReport:
        """Event-driven schedule of ``stream`` over the slots.

        Deterministic: events process in (time, slot index) order; the
        crossbar arbitrates active DMA bursts per beat (round-robin =
        processor sharing at rate 1/n; priority = strict preemption).
        With ``overlap=False`` a global lock admits one request at a
        time — the serialized single-kernel baseline, identical to
        back-to-back ``host_bridge.run_transaction`` calls.
        """
        from repro_torch.serve.metrics import StreamingHistogram

        stream = sorted(stream, key=lambda r: (r.arrival, r.rid))
        by_kernel: Dict[str, List[int]] = {}
        for i, s in enumerate(self.slots):
            by_kernel.setdefault(s.kernel_name, []).append(i)
        for r in stream:
            if r.kernel not in by_kernel:
                raise FabricError(
                    f"request {r.rid} names kernel {r.kernel!r} but no "
                    f"slot serves it (slots: "
                    f"{', '.join(sorted(by_kernel))})")

        costs = self._costs(device_cycles)
        st = [_SlotState() for _ in self.slots]
        qdepth = [StreamingHistogram(lo=0.5, hi=1e6, growth=1.05)
                  for _ in self.slots]
        latency = StreamingHistogram(lo=1.0, hi=1e12, growth=1.02)
        lines: List[str] = []
        t = 0.0
        xbar_busy = 0.0
        in_flight = 0
        completed = 0
        next_arrival = 0

        def say(msg: str) -> None:
            if transcript and len(lines) < 400:
                lines.append(f"t={int(round(t)):>10,}  {msg}")

        def phase_cost(i: int, ph: int) -> int:
            c = costs[i]
            return (c.csr_setup, c.dma_in, c.start, c.device, c.poll,
                    c.dma_out)[ph]

        def enter_phase(i: int, ph: int) -> None:
            s = st[i]
            s.phase = ph
            name, kind = _PHASES[ph]
            dur = phase_cost(i, ph)
            if kind == "xbar":
                s.dma_remaining = float(dur)
                s.phase_end = math.inf
                say(f"{self.slots[i].name}: {name} "
                    f"({dur} beats on the crossbar)")
            else:
                s.phase_end = t + dur
                say(f"{self.slots[i].name}: {name} ({dur} cyc)")

        def try_start(i: int) -> None:
            nonlocal in_flight
            s = st[i]
            if s.current is not None or not s.queue:
                return
            if not overlap and in_flight > 0:
                return
            s.current = s.queue.pop(0)
            in_flight += 1
            say(f"{self.slots[i].name}: start request "
                f"#{s.current.rid} ({s.current.kernel})")
            enter_phase(i, 0)

        def active_dma() -> List[int]:
            return [i for i, s in enumerate(st)
                    if s.current is not None
                    and _PHASES[s.phase][1] == "xbar"]

        def dma_winners(act: List[int]) -> List[int]:
            """Slots whose bursts progress right now (arbitration)."""
            if self.policy == "priority":
                best = min(self.slots[i].priority for i in act)
                return [i for i in act if self.slots[i].priority == best]
            return act                      # round-robin: all share

        def finish_phase(i: int) -> None:
            nonlocal in_flight, completed
            s = st[i]
            if s.phase + 1 < len(_PHASES):
                enter_phase(i, s.phase + 1)
                return
            req = s.current
            s.current = None
            s.phase = -1
            s.completed += 1
            in_flight -= 1
            completed += 1
            latency.record(max(t - req.arrival, 1.0))
            say(f"{self.slots[i].name}: request #{req.rid} done "
                f"(latency {int(round(t - req.arrival)):,} cyc)")
            if overlap:
                for j in range(len(st)):
                    try_start(j)
            else:
                # the global lock frees: admit the oldest waiting request
                # (global FIFO — the honest serialized baseline)
                waiting = [(st[j].queue[0].arrival, st[j].queue[0].rid, j)
                           for j in range(len(st))
                           if st[j].queue and st[j].current is None]
                if waiting:
                    try_start(min(waiting)[2])

        while next_arrival < len(stream) or in_flight > 0 \
                or any(s.queue for s in st):
            act = active_dma()
            winners = dma_winners(act) if act else []
            # -- next event time ------------------------------------------
            t_next = math.inf
            if next_arrival < len(stream):
                t_next = min(t_next, stream[next_arrival].arrival)
            for i, s in enumerate(st):
                if s.current is not None and _PHASES[s.phase][1] == "slot":
                    t_next = min(t_next, s.phase_end)
            if winners:
                rate = 1.0 / len(winners)   # beats/cycle each
                t_next = min(t_next, t + min(st[i].dma_remaining
                                             for i in winners) / rate)
            if t_next is math.inf:
                raise FabricError("fabric scheduler deadlocked "
                                  "(no runnable event)")      # pragma: no cover
            # -- advance shared-crossbar progress over [t, t_next] ---------
            dt = t_next - t
            if dt > 0:
                if act:
                    xbar_busy += dt
                if winners:
                    rate = 1.0 / len(winners)
                    for i in winners:
                        st[i].dma_remaining -= dt * rate
                for i, s in enumerate(st):
                    if s.current is not None:
                        s.busy_cycles += dt
            t = t_next
            # -- retire events at t (slot order: deterministic) ------------
            for i, s in enumerate(st):
                if s.current is not None and _PHASES[s.phase][1] == "xbar" \
                        and s.dma_remaining <= _EPS:
                    s.dma_remaining = 0.0
                    finish_phase(i)
            for i, s in enumerate(st):
                if s.current is not None and _PHASES[s.phase][1] == "slot" \
                        and s.phase_end <= t + _EPS:
                    finish_phase(i)
            while next_arrival < len(stream) \
                    and stream[next_arrival].arrival <= t + _EPS:
                r = stream[next_arrival]
                next_arrival += 1
                cands = by_kernel[r.kernel]
                tgt = min(cands, key=lambda i: (
                    len(st[i].queue) + (st[i].current is not None), i))
                st[tgt].queue.append(r)
                depth = len(st[tgt].queue) \
                    + (st[tgt].current is not None)
                qdepth[tgt].record(depth)
                say(f"host: dispatch #{r.rid} ({r.kernel}) -> "
                    f"{self.slots[tgt].name} (queue depth {depth})")
                try_start(tgt)

        makespan = int(round(t))
        seconds = makespan / (machine.clock_ghz * 1e9) if makespan else 0.0
        slot_rows = []
        for i, s in enumerate(st):
            slot_rows.append({
                "name": self.slots[i].name,
                "kernel": self.slots[i].kernel_name,
                "priority": self.slots[i].priority,
                "completed": s.completed,
                "busy_cycles": int(round(s.busy_cycles)),
                "utilization": round(s.busy_cycles / makespan, 4)
                               if makespan else 0.0,
                "queue_depth": {k: round(v, 3) for k, v in
                                qdepth[i].summary().items()},
            })
        return FabricReport(
            mode="overlap" if overlap else "serialized",
            policy=self.policy, device_source=source,
            crossbar=self.crossbar,
            requests=len(stream), completed=completed,
            total_cycles=makespan,
            requests_per_s=completed / seconds if seconds else 0.0,
            crossbar_busy_cycles=int(round(xbar_busy)),
            crossbar_utilization=round(xbar_busy / makespan, 6)
                                 if makespan else 0.0,
            latency_cycles={k: round(v, 3)
                            for k, v in latency.summary().items()},
            slots=slot_rows, device_cycles=dict(device_cycles),
            transcript=lines)


def make_fleet(kernels: Dict[str, Tuple[HwModule, Optional[Kernel]]],
               copies: Optional[Dict[str, int]] = None,
               crossbar: Crossbar = AXI4, policy: str = "round_robin",
               poll_interval: int = 64) -> Fabric:
    """Convenience constructor: ``{kernel name: (HwModule, Kernel?)}``
    (+ optional per-kernel copy counts) → a :class:`Fabric`.  Copies
    share the module object, so the event simulator executes each
    distinct module once.  Slot priority is declaration order."""
    slots = []
    for prio, (name, (mod, kernel)) in enumerate(kernels.items()):
        for c in range((copies or {}).get(name, 1)):
            slots.append(FabricSlot(name=f"{name}#{c}", kernel_name=name,
                                    module=mod, kernel=kernel,
                                    priority=prio))
    return Fabric(slots=slots, crossbar=crossbar, policy=policy,
                  poll_interval=poll_interval)


# --------------------------------------------------------------------------
# fleet-level DSE — throughput-under-contention × total-area frontier
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetChoice:
    """One kernel's slice of a fleet: which frontier schedule, how many
    copies."""

    kernel: str
    point: dse_mod.DsePoint
    copies: int


@dataclasses.dataclass
class FleetCandidate:
    """A priced fleet: total area vs modeled throughput under the mix."""

    choices: Tuple[FleetChoice, ...]
    area: int
    model_rps: float
    serialized_rps: float
    feasible: bool
    on_frontier: bool = False

    @property
    def speedup(self) -> float:
        return self.model_rps / self.serialized_rps \
            if self.serialized_rps else 0.0

    @property
    def key(self) -> Tuple[int, float]:
        return (self.area, -self.model_rps)

    def spec(self) -> str:
        return " + ".join(f"{c.kernel}:{c.point.family}x{c.copies}"
                          for c in self.choices)


@dataclasses.dataclass
class FleetValidation:
    """Event-simulator check of one frontier fleet (pricing symmetry)."""

    candidate: FleetCandidate
    sim_rps: float
    model_rps: float
    ok: bool
    max_abs_err: float = float("nan")

    @property
    def deviation_pct(self) -> float:
        if self.model_rps <= 0:
            return 0.0
        return 100.0 * abs(self.sim_rps - self.model_rps) / self.model_rps


@dataclasses.dataclass
class FleetResult:
    """Outcome of one :func:`explore_fleet` run."""

    mix: TrafficMix
    machine: MachineModel
    budget: dse_mod.ResourceBudget
    candidates: List[FleetCandidate]
    validations: List[FleetValidation]
    errors: List[Tuple[str, str]]

    @property
    def frontier(self) -> List[FleetCandidate]:
        return sorted((c for c in self.candidates if c.on_frontier),
                      key=lambda c: c.key)

    def best(self) -> Optional[FleetCandidate]:
        front = self.frontier
        return max(front, key=lambda c: c.model_rps) if front else None

    def table(self) -> str:
        rows = [f"// fleet dse under mix {self.mix.name!r}: "
                f"{len(self.candidates)} fleets priced, "
                f"{len(self.frontier)} on the req/s x area frontier"]
        rows.append(f"{'':2s}{'REQ/S':>12s} {'AREA':>10s} {'SPEEDUP':>8s}  "
                    f"FLEET")
        for c in sorted(self.candidates, key=lambda c: c.key):
            mark = "* " if c.on_frontier else ("  " if c.feasible else "! ")
            rows.append(f"{mark}{c.model_rps:>12,.1f} {c.area:>10,} "
                        f"{c.speedup:>7.2f}x  {c.spec()}")
        rows.append("// '*' = frontier (max req/s, min area), "
                    "'!' = infeasible under the resource budget; speedup "
                    "is overlap vs serialized dispatch of the same stream")
        for v in self.validations:
            status = "ok" if v.ok else "FAIL"
            rows.append(f"// sim-validate [{status}] {v.candidate.spec()}: "
                        f"simulated={v.sim_rps:,.1f} req/s vs "
                        f"modeled={v.model_rps:,.1f} "
                        f"(dev {v.deviation_pct:.2f}%)")
        for kernel, msg in self.errors:
            rows.append(f"// error {kernel}: {msg}")
        return "\n".join(rows)


def fleet_dominates(a: FleetCandidate, b: FleetCandidate) -> bool:
    """Strict Pareto domination on (requests/s ↑, area ↓)."""
    return (a.model_rps >= b.model_rps and a.area <= b.area
            and (a.model_rps > b.model_rps or a.area < b.area))


def _fleet_feasible(parts: Sequence[Tuple[dse_mod.DseCandidate, int]],
                    budget: dse_mod.ResourceBudget) -> bool:
    lanes = sum(c.resources.compute_lanes * n for c, n in parts)
    vmem = sum((c.resources.vmem_bytes + c.dbuf_bytes) * n
               for c, n in parts)
    regs = sum(c.resources.reg_bits * n for c, n in parts)
    return (lanes <= budget.max_lanes and vmem <= budget.max_vmem_bytes
            and regs <= budget.max_reg_bits)


def explore_fleet(graphs: Dict[str, Graph], mix: TrafficMix,
                  machine: MachineModel = TPU_V5E,
                  budget: Optional[dse_mod.ResourceBudget] = None,
                  crossbar: Crossbar = AXI4,
                  policy: str = "round_robin",
                  max_copies: int = 2,
                  per_kernel: int = 3,
                  validate_top: int = 2,
                  rps_tol_pct: float = 10.0,
                  seed: int = 0,
                  **dse_kwargs) -> FleetResult:
    """Optimize the *fleet* against ``mix`` under one total budget.

    Per kernel, ``dse.explore`` supplies the single-kernel cycles × area
    frontier; fleets are the cross product of (frontier point × copy
    count ≤ ``max_copies``) over the kernels ``mix`` names.  Each
    feasible fleet is priced by the fabric machine model (overlap vs
    serialized dispatch of the identical stream) and ranked on a
    requests/s × total-area Pareto frontier; the ``validate_top``
    highest-throughput frontier fleets are re-run through the fabric
    event simulator, which must agree with the model within
    ``rps_tol_pct`` percent (pricing symmetry, fabric-scale).
    """
    budget = budget or dse_mod.ResourceBudget.from_machine(machine)
    names = [k for k, _ in mix.weights]
    missing = [n for n in names if n not in graphs]
    if missing:
        raise FabricError(f"mix {mix.name!r} names kernels with no graph: "
                          f"{', '.join(missing)}")
    stream = fabric_stream(mix)

    errors: List[Tuple[str, str]] = []
    menu: Dict[str, List[Tuple[dse_mod.DseCandidate, HwModule,
                               Optional[Kernel]]]] = {}
    for name in names:
        res = dse_mod.explore(graphs[name], machine=machine, budget=budget,
                              validate_top=0, **dse_kwargs)
        for pt, msg in res.errors:
            errors.append((name, f"{pt.spec}: {msg}"))
        picks = res.frontier[:per_kernel] or res.candidates[:1]
        if not picks:
            raise FabricError(f"kernel {name!r}: no design point survived "
                              f"DSE (all candidates failed)")
        built = []
        for cand in picks:
            kernel, hw = dse_mod.build_point(graphs[name], cand.point,
                                             machine)
            built.append((cand, hw, kernel))
        menu[name] = built

    candidates: List[FleetCandidate] = []
    options = [[(name, cand, hw, kernel, n)
                for (cand, hw, kernel) in menu[name]
                for n in range(1, max_copies + 1)]
               for name in names]
    for combo in itertools.product(*options):
        parts = [(cand, n) for _, cand, _, _, n in combo]
        area = sum(cand.area * n for cand, n in parts)
        feasible = _fleet_feasible(parts, budget)
        choices = tuple(FleetChoice(kernel=name, point=cand.point, copies=n)
                        for name, cand, _, _, n in combo)
        if not feasible:
            candidates.append(FleetCandidate(
                choices=choices, area=area, model_rps=0.0,
                serialized_rps=0.0, feasible=False))
            continue
        fabric = make_fleet(
            {name: (hw, kernel) for name, _, hw, kernel, _ in combo},
            copies={name: n for name, _, _, _, n in combo},
            crossbar=crossbar, policy=policy)
        rps = fabric.model(stream, machine, overlap=True).requests_per_s
        ser = fabric.model(stream, machine, overlap=False).requests_per_s
        candidates.append(FleetCandidate(
            choices=choices, area=area, model_rps=rps,
            serialized_rps=ser, feasible=True))

    feas = [c for c in candidates if c.feasible]
    for c in feas:
        if not any(fleet_dominates(o, c) for o in feas):
            c.on_frontier = True

    validations: List[FleetValidation] = []
    if validate_top:
        combo_of = {id(c): combo for c, combo in
                    zip(candidates, itertools.product(*options))}
        front = sorted((c for c in candidates if c.on_frontier),
                       key=lambda c: -c.model_rps)
        for cand in front[:validate_top]:
            combo = combo_of[id(cand)]
            fabric = make_fleet(
                {name: (hw, kernel) for name, _, hw, kernel, _ in combo},
                copies={name: n for name, _, _, _, n in combo},
                crossbar=crossbar, policy=policy)
            rep = fabric.simulate(stream, machine, overlap=True, seed=seed)
            v = FleetValidation(candidate=cand, sim_rps=rep.requests_per_s,
                                model_rps=cand.model_rps, ok=True,
                                max_abs_err=rep.max_abs_err)
            v.ok = v.deviation_pct <= rps_tol_pct
            validations.append(v)
    return FleetResult(mix=mix, machine=machine, budget=budget,
                       candidates=candidates, validations=validations,
                       errors=errors)
