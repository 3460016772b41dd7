"""stagecc — the paper's compiler infrastructure, ported to PyTorch and CUDA.

Levels (Fig. 1 of the paper):
    frontend (SYCL/DPC++ role)  ->  TensorIR (MLIR role)
        ->  LoopIR (Calyx role)  ->  HwIR (FSM + datapath, the RTL role)
        ->  backends (eager PyTorch, an emitted CUDA GEMM) + Verilog-style
            text
with cycle/resource models derived structurally from the HwIR module
(the Vivado-report role), priced on the modelled TPU v5e as in the JAX
package.  Design-space exploration and autotuning are not ported yet.

See docs/ARCHITECTURE.md for the stage-by-stage map,
docs/LOWERING.md (generated) for one GEMM walked through every level,
and docs/PASSES.md (generated) for the pass reference.
"""

from .frontend import spec, trace
from .host_bridge import (AXI4, AXI4_LITE, Crossbar, TransactionReport,
                          csr_map, run_transaction)
from .hw_ir import HwModule, emit_verilog, lower_to_hw
from .hw_sim import (CoSimReport, SimError, SimMismatch, SimReport, cosim,
                     random_inputs, simulate)
from .ir_text import (ir_size, parse_graph, parse_hw_module, parse_ir,
                      parse_kernel, print_graph, print_hw_module, print_ir,
                      print_kernel)
from .lowering import LoweringOptions, lower_graph
from .machine_model import TPU_V5E, MachineModel, cycles, flops, hbm_bytes, resources
from .passes import (PASS_ALIASES, PASS_REGISTRY, PassDef, PassError,
                     PassManager, PassRecord, PipelineResult, parse_pipeline,
                     register_pass, run_pipeline)
from .pipeline import SCHEDULES, CompiledKernel, compile_gemm, compile_traced
from .rewrite import (CANONICAL_PATTERNS, OneShotPattern, Pattern,
                      RewriteDriver, RewriteError, RewriteStats, canonicalize,
                      register_canonical_pattern)
from .tensor_ir import Graph, OP_REGISTRY, TensorType, register_op

__all__ = [
    "spec", "trace", "LoweringOptions", "lower_graph", "TPU_V5E",
    "MachineModel", "cycles", "flops", "hbm_bytes", "resources",
    "PASS_ALIASES", "PASS_REGISTRY", "PassDef", "PassError", "PassManager",
    "PassRecord", "PipelineResult", "parse_pipeline", "register_pass",
    "run_pipeline",
    "HwModule", "emit_verilog", "lower_to_hw",
    "AXI4", "AXI4_LITE", "Crossbar", "TransactionReport", "csr_map",
    "run_transaction",
    "CoSimReport", "SimError", "SimMismatch", "SimReport", "cosim",
    "random_inputs", "simulate",
    "ir_size", "parse_graph", "parse_hw_module", "parse_ir", "parse_kernel",
    "print_graph", "print_hw_module", "print_ir", "print_kernel",
    "SCHEDULES", "CompiledKernel", "compile_gemm", "compile_traced",
    "Graph", "OP_REGISTRY", "TensorType", "register_op",
    "CANONICAL_PATTERNS", "OneShotPattern", "Pattern", "RewriteDriver",
    "RewriteError", "RewriteStats", "canonicalize",
    "register_canonical_pattern",
]
