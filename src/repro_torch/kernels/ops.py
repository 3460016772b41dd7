"""Public wrappers for the kernels package.

The port of ``repro/kernels/ops.py``.  ``backend`` selects the path:
  * "torch" — plain PyTorch (runs on any device);
  * "cuda"  — the compiler-emitted CUDA kernel on CUDA tensors, its plain
              version on CPU tensors.
``attention`` and ``ssd`` come with their kernels.
"""

from __future__ import annotations

import torch

from . import ref
from .gemm import cuda_gemm

BACKENDS = ("torch", "cuda")


def matmul(a: torch.Tensor, b: torch.Tensor, backend: str = "torch",
           schedule: str = "tpu_mxu_kgrid") -> torch.Tensor:
    if backend == "torch":
        return ref.gemm_ref(a, b)
    if backend == "cuda":
        return cuda_gemm(a, b, schedule=schedule)
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
