"""Host ↔ device coupling model — the paper's vendor-crossbar integration.

The paper's end-to-end flow does not stop at RTL: the generated module is
packaged as an IP core and "coupled with the host CPU using
vendor-specific crossbars" (Fig. 1's AXI interconnect).  This module
models that last hop so a *complete* transaction can be simulated:

    host writes input buffers over DMA  →  host kicks the CSR start bit
        →  device FSM runs (hw_sim)  →  host polls the done bit
        →  host reads output buffers back over DMA

Three pieces:

  * :class:`Crossbar` — the interconnect: data-beat width, a fixed
    per-transaction handshake latency, and a CSR access cost.  Presets
    model an AXI4 burst port (wide) and an AXI4-Lite port (narrow).
  * :func:`csr_map` — the module's memory-mapped control/status register
    block, generated from its ports exactly like the paper's IP-core
    wrapper: CTRL/STATUS/CYCLES plus an address+length pair per port.
  * :func:`run_transaction` — the full transaction simulator.  Device
    cycles come from :func:`repro_torch.core.hw_sim.simulate` (observed, not
    analytic); host-side cycles are charged per DMA beat, per CSR
    access, and per polling round-trip, all in the same device-clock
    domain, so crossbar latency and width visibly move the end-to-end
    cycle count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hw_sim
from .hw_ir import HwModule, HwPort
from .machine_model import TPU_V5E, MachineModel
from .tensor_ir import dtype_bytes


@dataclasses.dataclass(frozen=True)
class Crossbar:
    """One host↔device interconnect port (the vendor crossbar).

    ``data_width_bits`` is the beat width of the DMA channel;
    ``latency_cycles`` the fixed address/handshake cost paid once per
    DMA transfer; ``csr_access_cycles`` the cost of one memory-mapped
    register read or write (CSRs ride the narrow control path).
    """

    name: str = "axi4"
    data_width_bits: int = 128
    latency_cycles: int = 24
    csr_access_cycles: int = 4

    def __post_init__(self):
        if self.data_width_bits <= 0 or self.data_width_bits % 8:
            raise ValueError(f"crossbar {self.name}: data width must be a "
                             f"positive multiple of 8 bits")

    def dma_cycles(self, nbytes: int) -> int:
        """Cycles to move ``nbytes`` in one burst transfer."""
        beats = math.ceil(8 * nbytes / self.data_width_bits)
        return self.latency_cycles + beats


#: a wide burst-capable memory port and the narrow control-plane port
AXI4 = Crossbar("axi4", data_width_bits=128, latency_cycles=24)
AXI4_LITE = Crossbar("axi4_lite", data_width_bits=32, latency_cycles=8,
                     csr_access_cycles=8)

#: named crossbar configurations the CLI/fabric accept by name
CROSSBAR_PRESETS: Dict[str, Crossbar] = {
    "axi4": AXI4,
    "axi4_lite": AXI4_LITE,
}


def crossbar_preset(name: str) -> Crossbar:
    """Look up a crossbar preset (case-insensitive).  Raises ``KeyError``
    naming the valid presets on a miss; the CLI adds its did-you-mean
    hint on top."""
    key = name.strip().lower()
    if key not in CROSSBAR_PRESETS:
        raise KeyError(f"unknown crossbar preset {name!r} "
                       f"(choose from {', '.join(CROSSBAR_PRESETS)})")
    return CROSSBAR_PRESETS[key]


class PollTimeout(RuntimeError):
    """The host gave up polling STATUS before the device reported done."""


# --------------------------------------------------------------------------
# CSR block
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CsrField:
    offset: int
    name: str
    doc: str


def csr_map(mod: HwModule) -> List[CsrField]:
    """The module's memory-mapped register block, IP-core-wrapper style:
    CTRL (bit0 = start), STATUS (bit0 = done), CYCLES (observed cycle
    counter), then an address + length register pair per memory port."""
    fields = [
        CsrField(0x00, "CTRL", "bit0: start (write 1 to launch)"),
        CsrField(0x04, "STATUS", "bit0: done (clears on start)"),
        CsrField(0x08, "CYCLES", "device cycle counter of the last run"),
    ]
    off = 0x10
    for p in mod.ports:
        fields.append(CsrField(off, f"{p.name.upper()}_ADDR",
                               f"host buffer address of port {p.name} "
                               f"({p.direction})"))
        fields.append(CsrField(off + 4, f"{p.name.upper()}_LEN",
                               f"transfer length of port {p.name} "
                               f"({port_bytes(p)} bytes)"))
        off += 8
    return fields


def port_bytes(p: HwPort) -> int:
    return p.elems * dtype_bytes(p.dtype)


# --------------------------------------------------------------------------
# transaction simulation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    """One phase of the host transaction, with its cycle cost."""

    name: str                       # "csr_setup" | "dma_in" | "start" | ...
    cycles: int
    detail: str = ""

    def __str__(self):
        return f"{self.name:<10} {self.cycles:>10,} cyc  {self.detail}"


@dataclasses.dataclass
class TransactionReport:
    """A complete host→device→host round trip."""

    module: str
    crossbar: Crossbar
    sim: hw_sim.SimReport           # the device-side run
    phases: List[Phase]
    csr_trace: List[Tuple[int, str, str, int]]   # (cycle, op, reg, value)

    @property
    def total_cycles(self) -> int:
        return sum(p.cycles for p in self.phases)

    @property
    def device_cycles(self) -> int:
        return self.sim.cycles.total

    @property
    def host_overhead_cycles(self) -> int:
        """Cycles the transaction spends outside the device FSM."""
        return self.total_cycles - self.device_cycles

    @property
    def outputs(self) -> List[np.ndarray]:
        return self.sim.outputs

    def summary(self) -> str:
        lines = [f"transaction {self.module} over {self.crossbar.name} "
                 f"(width={self.crossbar.data_width_bits}b, "
                 f"latency={self.crossbar.latency_cycles}cyc): "
                 f"{self.total_cycles:,} cycles total"]
        lines += [f"  {p}" for p in self.phases]
        lines.append(f"  host overhead: {self.host_overhead_cycles:,} "
                     f"cycles over the {self.device_cycles:,}-cycle kernel")
        return "\n".join(lines)


def _validate_inputs(mod: HwModule, inputs: Sequence[np.ndarray]) -> None:
    """Host-side argument checking against the port declarations — the
    crossbar wrapper rejects a malformed DMA descriptor instead of
    silently casting or truncating.  Fewer inputs than ``in`` ports is
    legal (unbound HBM temporaries read zeros, as in ``hw_sim``)."""
    in_ports = [p for p in mod.ports if p.direction == "in"]
    if len(inputs) > len(in_ports):
        raise ValueError(
            f"module {mod.name} has {len(in_ports)} input port(s) but "
            f"{len(inputs)} input buffer(s) were given")
    for p, a in zip(in_ports, inputs):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"module {mod.name}, port {p.name}: input shape "
                f"{tuple(a.shape)} != declared {tuple(p.shape)}")
        # the carried numpy dtype (bfloat16 rides in float32, as in the
        # oracle and the simulator)
        want = np.dtype(hw_sim._np_dtype(p.dtype))
        if a.dtype != want:
            raise ValueError(
                f"module {mod.name}, port {p.name}: input dtype "
                f"{a.dtype} != declared {want} (the DMA engine moves "
                f"raw beats; cast on the host first)")


def run_transaction(mod: HwModule, inputs: Sequence[np.ndarray],
                    machine: MachineModel = TPU_V5E,
                    crossbar: Crossbar = AXI4,
                    poll_interval: int = 64,
                    poll_timeout: Optional[int] = None,
                    trace: bool = False,
                    sim: Optional[hw_sim.SimReport] = None
                    ) -> TransactionReport:
    """Simulate the full host-coupled flow of the paper's Fig. 1.

    Phases, all in device-clock cycles:

    1. **csr_setup** — the host programs every port's ADDR/LEN register
       pair (two CSR writes per port);
    2. **dma_in** — input buffers stream device-ward, one burst per
       ``in`` port (handshake latency + one cycle per data beat);
    3. **start** — one CSR write sets CTRL.start;
    4. **device** — the module FSM runs (:func:`hw_sim.simulate`; the
       *observed* cycle count, not the analytic model);
    5. **poll** — the host reads STATUS every ``poll_interval`` cycles
       until done; completion is only visible at a poll boundary, so the
       phase rounds the device run up and adds one CSR read per poll;
    6. **dma_out** — every write-channel (``out``/``inout``) port
       streams back to the host.

    ``poll_timeout`` caps the number of STATUS polls the host issues:
    if the device run would need more, the transaction raises
    :class:`PollTimeout` instead of spinning — the watchdog every real
    host driver arms against a wedged device.

    Pass ``sim`` to reuse an already-computed device run (e.g. from a
    preceding co-simulation of the same module and inputs) instead of
    simulating a second time.
    """
    _validate_inputs(mod, inputs)
    if poll_timeout is not None and poll_timeout < 1:
        raise ValueError(f"poll_timeout must be >= 1, got {poll_timeout}")
    fields = {f.name: f for f in csr_map(mod)}
    csr_trace: List[Tuple[int, str, str, int]] = []
    phases: List[Phase] = []
    now = 0

    def csr(op: str, reg: str, value: int = 0) -> int:
        """One CSR access: stamped at issue time, advancing the clock."""
        nonlocal now
        if reg not in fields:
            raise KeyError(f"no CSR named {reg!r} on module {mod.name}")
        csr_trace.append((now, op, reg, value))
        now += crossbar.csr_access_cycles
        return crossbar.csr_access_cycles

    # 1. program the address map
    cost = 0
    for i, p in enumerate(mod.ports):
        cost += csr("write", f"{p.name.upper()}_ADDR", 0x1000_0000 + i * 0x100000)
        cost += csr("write", f"{p.name.upper()}_LEN", port_bytes(p))
    phases.append(Phase("csr_setup", cost,
                        f"{2 * len(mod.ports)} CSR writes (ADDR/LEN per port)"))

    # 2. DMA inputs device-ward
    cost = 0
    n_in = 0
    for p in mod.ports:
        if p.direction == "in":
            cost += crossbar.dma_cycles(port_bytes(p))
            n_in += 1
    now += cost
    phases.append(Phase("dma_in", cost,
                        f"{n_in} burst(s), {crossbar.latency_cycles} cyc "
                        f"handshake + 1 cyc/beat @{crossbar.data_width_bits}b"))

    # 3. kick
    cost = csr("write", "CTRL", 1)
    phases.append(Phase("start", cost, "CTRL.start <= 1"))

    # 4. the device runs (observed cycles)
    rep = sim if sim is not None else hw_sim.simulate(mod, inputs,
                                                      machine=machine,
                                                      trace=trace)
    device_start = now
    now += rep.cycles.total
    phases.append(Phase("device", rep.cycles.total,
                        f"module FSM: {rep.steps_retired:,} steps, "
                        f"{rep.fsm_transitions:,} transitions"))

    # 5. poll STATUS until done — completion visible only at poll edges.
    # The polls themselves land *during* the device run, spaced one
    # interval apart (trace-stamped at their real issue cycles); their
    # access cost is charged serially to the host here.
    polls = max(1, math.ceil(rep.cycles.total / max(1, poll_interval)))
    if poll_timeout is not None and polls > poll_timeout:
        raise PollTimeout(
            f"module {mod.name}: device needs {rep.cycles.total:,} cycles "
            f"(≥ {polls} polls at interval {poll_interval}) but the host "
            f"gives up after {poll_timeout} poll(s); raise poll_timeout "
            f"or poll_interval")
    wait = polls * poll_interval - rep.cycles.total   # residual quantisation
    for i in range(min(polls, 4)):                    # keep the trace short
        csr_trace.append((device_start + (i + 1) * poll_interval,
                          "read", "STATUS", 0))
    if polls > 4:
        csr_trace.append((device_start + polls * poll_interval,
                          "read", "STATUS(xN)", polls - 4))
    now += wait + polls * crossbar.csr_access_cycles
    cost = wait + polls * crossbar.csr_access_cycles
    cost += csr("read", "CYCLES", rep.cycles.total)
    phases.append(Phase("poll", cost,
                        f"{polls} STATUS read(s) every {poll_interval} cyc "
                        f"+ CYCLES readback"))

    # 6. DMA results host-ward
    cost = 0
    n_out = 0
    for p in mod.ports:
        if p.direction in ("out", "inout"):
            cost += crossbar.dma_cycles(port_bytes(p))
            n_out += 1
    now += cost
    phases.append(Phase("dma_out", cost, f"{n_out} burst(s) back to host"))

    report = TransactionReport(module=mod.name, crossbar=crossbar, sim=rep,
                               phases=phases, csr_trace=csr_trace)
    assert report.total_cycles == now   # phase costs account every cycle
    return report
