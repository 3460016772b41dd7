"""Integration layer — the AXI-wrapper analogue.

The paper wraps its generated hardware module "with an AXI-full interface
and a synthesizable IP core" so the accelerator couples to the host CPU.
In PyTorch the host/device contract of a generated kernel is a
**differentiable** op (``torch.autograd.Function``), so the kernel drops
into a training step.

``gemm_op`` builds that wrapper around a stagecc-compiled GEMM:
forward = the compiled kernel; backward = two more stagecc GEMMs
(dA = dC @ B^T, dB = A^T @ dC) compiled through the same pipeline — the
whole training-facing surface is generated by the infrastructure.
``sharded_gemm_op`` runs it per rank on a row block of the lhs, the
reference's ``shard_map`` deployment, as a ``local_map`` region.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .pipeline import compile_gemm

BACKENDS = ("torch", "cuda")


@functools.lru_cache(maxsize=64)
def _compiled(m: int, n: int, k: int, schedule: str, backend: str,
              dtype: str = "float32"):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    ck = compile_gemm(m, n, k, schedule=schedule, dtype=dtype,
                      want_torch=(backend == "torch"),
                      want_cuda=(backend == "cuda"))
    if backend == "torch":
        f = ck.run_torch
        return lambda a, b: f(a, b)[0]
    if ck.run_cuda is None:
        raise ValueError(f"schedule {schedule} has no cuda emission")
    return ck.run_cuda


def _dtype(a: torch.Tensor, b: torch.Tensor) -> str:
    """The plan's operand type for these operands: bf16 when both are bf16
    (their products are exact in the f32 sum, so the arithmetic is that of
    the f32 plan on the widened operands), else f32."""
    bf16 = a.dtype == b.dtype == torch.bfloat16
    return "bfloat16" if bf16 else "float32"


class _GemmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, m, n, k, schedule, backend):
        ctx.save_for_backward(a, b)
        ctx.key = (m, n, k, schedule, backend)
        return _compiled(m, n, k, schedule, backend, _dtype(a, b))(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m, n, k, schedule, backend = ctx.key
        # the gradients are stagecc-compiled GEMMs too; the transposes are
        # views, which the kernel reads through their strides
        ga, gb = g.to(a.dtype), g.to(b.dtype)
        da = _compiled(m, k, n, schedule, backend, _dtype(ga, b))(ga, b.t())
        db = _compiled(k, n, m, schedule, backend, _dtype(a, gb))(a.t(), gb)
        return da.to(a.dtype), db.to(b.dtype), None, None, None, None, None


def gemm_op(m: int, n: int, k: int, schedule: str = "tpu_mxu",
            backend: str = "torch") -> Callable:
    """Differentiable (m,k)x(k,n) GEMM generated by the stagecc pipeline.

    backend: "torch" (the eager interpreter, runs anywhere) | "cuda" (the
    emitted CUDA kernel; its plain version on CPU tensors).  Each product
    is compiled for its operands' type (bf16 when both are bf16, else f32);
    the products have an f32 output, and the gradients are cast back to
    each operand's type.
    """
    _compiled(m, n, k, schedule, backend)       # refuse a bad pair early

    def op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _GemmFn.apply(a, b, m, n, k, schedule, backend)

    return op


def sharded_gemm_op(mesh, m: int, n: int, k: int, schedule: str = "tpu_mxu",
                    backend: str = "torch",
                    lhs_axis: Optional[str] = "data") -> Callable:
    """The crossbar: the generated kernel per rank, with the lhs
    row-sharded over ``lhs_axis`` of ``mesh`` (a ``DeviceMesh``) and the
    rhs replicated (the canonical data-parallel deployment of an
    accelerator IP block).

    The op takes DTensors (``redistribute_inputs``: each is redistributed
    to those placements first) and returns one sharded ``Shard(0)`` over
    ``lhs_axis``, replicated elsewhere.  Each rank runs ``gemm_op(m //
    shards, n, k)`` on its row block, forward and the two backward GEMMs;
    the rhs gradient is each rank's partial sum, a ``Partial`` placement
    over ``lhs_axis`` (the reduction ``shard_map``'s transpose makes).
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import mesh_shape
    n_shards = mesh_shape(mesh)[lhs_axis]
    if m % n_shards:
        raise ValueError(f"m={m} not divisible by {lhs_axis}={n_shards}")
    local = gemm_op(m // n_shards, n, k, schedule, backend)
    names = mesh.mesh_dim_names
    rows = [Shard(0) if a == lhs_axis else Replicate() for a in names]
    rep = [Replicate() for _ in names]
    summed = [Partial() if a == lhs_axis else Replicate() for a in names]
    return local_map(local, out_placements=rows, in_placements=(rows, rep),
                     in_grad_placements=(rows, summed), device_mesh=mesh,
                     redistribute_inputs=True)
