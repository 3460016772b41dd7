"""GEMM kernels — the paper's case study, generated by the stagecc stack.

The port of ``repro/kernels/gemm.py``.  ``cuda_gemm`` is *emitted* by the
compiler infrastructure (frontend -> TensorIR -> LoopIR -> schedule ->
CUDA source on ``csrc/stagecc_gemm.cuh``), so the paper's whole pipeline
sits on the hot path.  Both block schedules exist:

  * ``tpu_mxu_kgrid`` — the k tiles walked in order inside each block,
    the output-typed sum rounded after each (the reference's revisited
    output block);
  * ``tpu_mxu``       — all of K summed in one f32 accumulator.

``auto_gemm`` runs the same template at the schedule and tiles the
cost-model search picks (``core.autotune.best_schedule``).

``cuda_gemm.launches`` counts the launches of every emitted GEMM kernel,
whichever entry point (``cuda_gemm``, ``auto_gemm``, ``CompiledKernel.run_cuda``,
``integrate.gemm_op``) made them; ``cuda_gemm.wgmma_launches`` those of
them on the tensor-core route (``backend_cuda._gemm_route``: bf16
operands, tk a multiple of 16, operands TMA can read) and
``cuda_gemm.ffma_launches`` those on the register-tiled CUDA-core route
(``csrc/stagecc_gemm_ffma.cuh``: tiles multiples of 64, tk of 8, operands
it can read 16 bytes at a time).  The rest run ``csrc/stagecc_gemm.cuh``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.autotune import compile_gemm_autotuned
from repro_torch.core.pipeline import compile_gemm

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _pick_tile(dim: int, pref: int = 128) -> int:
    t = min(pref, dim)
    while dim % t:
        t -= 1
    return t


@functools.lru_cache(maxsize=256)
def _build(m: int, n: int, k: int, schedule: str, dtype: str,
           tm: int, tn: int, tk: int):
    ck = compile_gemm(m, n, k, schedule=schedule, dtype=dtype,
                      tile={"m": tm, "n": tn, "k": tk},
                      want_torch=False, want_cuda=True)
    if ck.run_cuda is None:
        raise RuntimeError(f"stagecc failed to emit cuda for {ck.name}")
    return ck


@functools.lru_cache(maxsize=256)
def _build_auto(m: int, n: int, k: int, dtype: str):
    """The emitted GEMM at the schedule and tiles the cost-model search
    picks (``core.autotune``), compiled once per (m, n, k, dtype)."""
    ck = compile_gemm_autotuned(m, n, k, dtype=dtype)
    if ck.run_cuda is None:
        raise RuntimeError(f"stagecc failed to emit cuda for {ck.name}")
    return ck


def auto_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,k) @ (k,n) through the emitted CUDA kernel at the searched
    schedule and tiles (its plain version for CPU tensors): the port of
    the reference's ``pallas_auto``.  f32 and bf16 operands keep their
    dtype; others are computed in f32."""
    m, kdim = a.shape
    k2, n = b.shape
    if kdim != k2:
        raise ValueError(f"auto_gemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    ck = _build_auto(m, n, kdim, _DTYPES.get(a.dtype, "float32"))
    return ck.run_cuda(a, b)


def cuda_gemm(a: torch.Tensor, b: torch.Tensor, *,
              schedule: str = "tpu_mxu_kgrid", tile: int = 128
              ) -> torch.Tensor:
    """(m,k) @ (k,n) through the stagecc-emitted CUDA kernel (its plain
    version for CPU tensors).  f32 and bf16 operands keep their dtype;
    others are computed in f32."""
    m, kdim = a.shape
    k2, n = b.shape
    if kdim != k2:
        raise ValueError(f"cuda_gemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    ck = _build(m, n, kdim, schedule, _DTYPES.get(a.dtype, "float32"),
                _pick_tile(m, tile), _pick_tile(n, tile),
                _pick_tile(kdim, tile))
    return ck.run_cuda(a, b)


cuda_gemm.launches = 0      # emitted-GEMM kernel launches (CUDA tensors)
cuda_gemm.wgmma_launches = 0    # of those, on the tensor-core route
cuda_gemm.ffma_launches = 0     # of those, on the register-tiled route


def gemm_cost(m: int, n: int, k: int, schedule: str = "tpu_mxu_kgrid",
              tile: int = 128):
    """(cycles, resources) of the generated kernel — TABLE I / Fig. 3
    terms, modelled on the TPU v5e machine model, not GPU times."""
    ck = _build(m, n, k, schedule, "float32",
                _pick_tile(m, tile), _pick_tile(n, tile), _pick_tile(k, tile))
    return ck.cycles, ck.resources
