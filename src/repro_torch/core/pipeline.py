"""End-to-end compile driver — the paper's "encapsulation script".

``compile_gemm`` / ``compile_traced`` run the full Fig.-1 flow:

    python fn  --frontend-->  TensorIR  --lower-->  LoopIR
        --schedule passes-->  scheduled LoopIR
        --lower-to-hw-->      HwIR (FSM + datapath module)
        --backend-->          {numpy oracle | eager PyTorch | CUDA kernel}
        --models-->           cycles (TABLE I) + resources (Fig. 3),
                              derived structurally from the HwIR module

and return everything a caller (tests, benchmarks, the integration layer)
needs in one artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from . import (backend_cuda, backend_ref, backend_torch, host_bridge, hw_ir,
               hw_sim, machine_model)
from .frontend import spec, trace
from .hw_ir import HwModule
from .lowering import LoweringOptions, lower_graph
from .machine_model import TPU_V5E, CycleReport, MachineModel, ResourceReport
from .passes import PassManager, PassRecord
from .tensor_ir import Graph


SCHEDULES = ("nested", "inner_flattened", "tpu_mxu", "tpu_mxu_kgrid")


@dataclasses.dataclass
class CompiledKernel:
    name: str
    graph: Graph
    kernel: "Kernel"                  # scheduled LoopIR
    hw_module: HwModule               # lowered FSM + datapath hardware
    schedule: str
    cycles: CycleReport               # structural, from hw_module
    resources: ResourceReport         # structural, from hw_module
    flops: int
    hbm_bytes: int
    run_ref: Callable                  # numpy oracle
    run_torch: Optional[Callable]      # eager PyTorch interpreter
    run_cuda: Optional[Callable]       # emitted CUDA kernel (plain on CPU)
    machine: MachineModel = TPU_V5E    # the model the reports were priced on
    pass_records: List[PassRecord] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (f"{self.name}[{self.schedule}]: {self.cycles}, "
                f"{self.resources}, flops={self.flops:,}, "
                f"hbm={self.hbm_bytes:,}B")

    # ---- co-simulation ----------------------------------------------------

    def simulate(self, *inputs, trace: bool = False, check: bool = True,
                 atol: float = 1e-5) -> hw_sim.CoSimReport:
        """Run the lowered hardware module cycle-accurately on ``inputs``
        (the Vivado-simulation leg of the paper's flow).

        Co-simulation: outputs are checked against the numpy oracle
        (``run_ref``) and the observed cycle count is packaged next to
        the analytic ``machine_model.cycles`` prediction.  Raises
        :class:`repro_torch.core.hw_sim.SimMismatch` if any output deviates
        beyond ``atol``.
        """
        return hw_sim.cosim(self.hw_module, self.kernel, list(inputs),
                            machine=self.machine, modeled=self.cycles.total,
                            trace=trace, check=check, atol=atol)

    def simulate_host(self, *inputs,
                      crossbar: host_bridge.Crossbar = host_bridge.AXI4,
                      poll_interval: int = 64,
                      trace: bool = False) -> host_bridge.TransactionReport:
        """Simulate the full host-coupled transaction (DMA in → CSR start
        → poll done → DMA out) over ``crossbar`` — the paper's
        vendor-crossbar integration of the generated IP core."""
        return host_bridge.run_transaction(
            self.hw_module, list(inputs), machine=self.machine,
            crossbar=crossbar, poll_interval=poll_interval, trace=trace)

    # ---- design-space exploration -----------------------------------------

    def explore(self, **kwargs):
        """Design-space exploration around this kernel's source graph:
        search schedule programs × HwIR knobs on this kernel's machine
        and return the priced/validated Pareto frontier
        (:class:`repro_torch.core.dse.DseResult`).  Keyword arguments forward
        to :func:`repro_torch.core.dse.explore` (``validate_top``, ``budget``,
        ``tiles``, ``workers``, ``cache_dir``, ...)."""
        from . import dse

        kwargs.setdefault("machine", self.machine)
        return dse.explore(self.graph, **kwargs)

    def explore_fleet(self, others: Sequence["CompiledKernel"] = (),
                      mix=None, **kwargs):
        """Fleet-level DSE: optimize this kernel *plus* ``others`` as
        one multi-accelerator fabric behind a shared crossbar — which
        kernel gets which frontier schedule, how many copies — against
        a traffic mix, ranked on a requests/s × total-area frontier
        (:class:`repro_torch.core.fabric.FleetResult`).  With no ``mix``, an
        even mix over the kernel set is generated at ~2× the fleet's
        serialized capacity so contention is visible.  Keyword arguments
        forward to :func:`repro_torch.core.fabric.explore_fleet`
        (``budget``, ``crossbar``, ``max_copies``, ``validate_top``,
        ...)."""
        import dataclasses as _dc

        from . import fabric

        kernels = [self, *others]
        graphs = {ck.name: ck.graph for ck in kernels}
        if len(graphs) != len(kernels):
            raise ValueError("explore_fleet: kernel names must be unique, "
                             f"got {[ck.name for ck in kernels]}")
        kwargs.setdefault("machine", self.machine)
        if mix is None:
            crossbar = kwargs.get("crossbar", host_bridge.AXI4)
            mix = fabric.TrafficMix(
                "even", tuple((ck.name, 1.0) for ck in kernels),
                num_requests=8 * len(kernels), rate=1.0)
            mean = sum(fabric.transaction_cost(
                ck.hw_module, crossbar, ck.cycles.total).total
                for ck in kernels) / len(kernels)
            mix = _dc.replace(mix, cycles_per_unit=fabric.
                              saturating_cycles_per_unit(
                                  mix, mean,
                                  load_factor=2.0 * len(kernels)))
        return fabric.explore_fleet(graphs, mix, **kwargs)


def _pipeline_for(schedule: str, tile: Dict[str, int]) -> str:
    t = f"tile_m={tile['m']},tile_n={tile['n']},tile_k={tile['k']}"
    if schedule == "nested":
        return f"lower{{{t}}}"
    if schedule == "inner_flattened":
        return f"lower{{{t}}},flatten-inner"
    if schedule == "tpu_mxu":
        # (i, j) grid, K inside the block — flattened analogue
        return f"lower{{{t}}},fuse-epilogue,grid{{vars=2}}"
    if schedule == "tpu_mxu_kgrid":
        # (i, j, k) grid — time-multiplexed analogue
        return f"lower{{{t}}},fuse-epilogue,grid{{vars=3}}"
    raise ValueError(f"unknown schedule {schedule!r}; choose from {SCHEDULES}")


def compile_traced(fn_or_graph, in_specs: Optional[Sequence[spec]] = None,
                   schedule: str = "tpu_mxu",
                   tile: Optional[Dict[str, int]] = None,
                   machine: MachineModel = TPU_V5E,
                   want_torch: bool = True,
                   want_cuda: bool = True,
                   device: str = "cuda",
                   canonicalize: bool = False,
                   pipeline: Optional[str] = None) -> CompiledKernel:
    """Compile through the full stack; with ``canonicalize=True`` the
    level-agnostic ``canonicalize`` pass runs between lowerings (on the
    TensorIR input, on the scheduled LoopIR, and on the HwIR module) —
    semantics are preserved (cosim-checked in the test suite) but the
    canonical form may drop degenerate structure (extent-1 loops,
    duplicate datapath units), so modeled cycles/resources can differ
    from the uncanonicalized spelling.

    ``pipeline`` overrides the canned ``schedule``/``tile`` pair with an
    explicit pass-pipeline string (the ``reproc --pipeline`` spelling) —
    the schedule label on the artifact becomes the pipeline text.

    ``device`` is where ``run_torch`` and ``run_cuda`` put numpy inputs;
    tensor inputs stay on their own device.  ``run_cuda`` is the emitted
    GEMM for a single scheduled contraction and the general emitter's
    per-nest kernels for everything else (``backend_cuda.emit``); it is
    None where both refuse the kernel, as ``run_pallas`` is in the
    reference (a stage over 4096 traced statements, an interior @grid
    loop, ...).
    """
    if isinstance(fn_or_graph, Graph):
        graph = fn_or_graph
    else:
        graph = trace(fn_or_graph, in_specs)
    if pipeline is not None:
        pipe = schedule = pipeline
    else:
        tile = tile or ({"m": 1, "n": 1, "k": 1}
                        if schedule in ("nested", "inner_flattened")
                        else {"m": 128, "n": 128, "k": 128})
        # clamp tiles to the actual problem inside lowering
        pipe = _pipeline_for(schedule, tile)
    if canonicalize:
        pipe = f"canonicalize,{pipe},canonicalize"
    pres = PassManager.parse(pipe).run(graph)
    kernel = pres.artifact
    hw = hw_ir.lower_to_hw(kernel, mxu_min_dim=machine.mxu_min_dim)
    records = list(pres.records)
    if canonicalize:
        hwres = PassManager().add("canonicalize").run(hw)
        hw = hwres.artifact
        records += hwres.records
    cyc = machine_model.cycles(hw, machine)
    res = machine_model.resources(hw, machine)
    run_ref = lambda *xs: backend_ref.run(kernel, xs)
    run_torch = backend_torch.emit(kernel, device) if want_torch else None
    run_cuda = None
    if want_cuda:
        try:
            run_cuda = backend_cuda.emit(kernel, device)
        except backend_cuda.EmitError:
            run_cuda = None
    return CompiledKernel(
        name=graph.name, graph=graph, kernel=kernel, hw_module=hw,
        schedule=schedule,
        cycles=cyc, resources=res, flops=machine_model.flops(kernel),
        hbm_bytes=machine_model.hbm_bytes(kernel),
        run_ref=run_ref, run_torch=run_torch, run_cuda=run_cuda,
        machine=machine, pass_records=records)


def compile_gemm(m: int, n: int, k: int, schedule: str = "tpu_mxu",
                 dtype: str = "float32", epilogue: str = "none",
                 tile: Optional[Dict[str, int]] = None,
                 machine: MachineModel = TPU_V5E,
                 device: str = "cuda",
                 want_torch: bool = True,
                 want_cuda: bool = True,
                 canonicalize: bool = False) -> CompiledKernel:
    """The paper's GEMM case study, parameterised by schedule/epilogue."""
    from . import frontend as fe

    if epilogue == "none":
        def f(a, b):
            return fe.matmul(a, b)
        specs = [spec((m, k), dtype), spec((k, n), dtype)]
    elif epilogue == "bias_relu":
        def f(a, b, bias):
            return fe.relu(fe.matmul(a, b) + bias)
        specs = [spec((m, k), dtype), spec((k, n), dtype), spec((n,), "float32")]
    elif epilogue == "relu":
        def f(a, b):
            return fe.relu(fe.matmul(a, b))
        specs = [spec((m, k), dtype), spec((k, n), dtype)]
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    g = trace(f, specs, name=f"gemm_{m}x{n}x{k}_{epilogue}")
    return compile_traced(g, schedule=schedule, tile=tile, machine=machine,
                          device=device, want_torch=want_torch,
                          want_cuda=want_cuda, canonicalize=canonicalize)


from .loop_ir import Kernel  # noqa: E402
