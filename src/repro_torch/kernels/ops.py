"""Public wrappers for the kernels package.

The port of ``repro/kernels/ops.py``.  ``backend`` selects the path:
  * "torch" — plain PyTorch (runs on any device);
  * "cuda"  — the CUDA kernel on CUDA tensors (compiler-emitted for
              ``matmul``, hand-written for ``attention`` and ``ssd``), its
              plain version on CPU tensors;
  * "cuda_auto" (``matmul`` only) — the emitted GEMM at the schedule and
              tiles the cost-model search picks (``core/autotune.py``),
              as the reference's ``pallas_auto``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention
from .gemm import auto_gemm, cuda_gemm
from .ssd_scan import ssd_chunked, ssd_scan

BACKENDS = ("torch", "cuda", "cuda_auto")


def matmul(a: torch.Tensor, b: torch.Tensor, backend: str = "torch",
           schedule: str = "tpu_mxu_kgrid") -> torch.Tensor:
    if backend == "torch":
        return ref.gemm_ref(a, b)
    if backend == "cuda":
        return cuda_gemm(a, b, schedule=schedule)
    if backend == "cuda_auto":
        return auto_gemm(a, b)
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, backend: str = "torch",
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Batched multi-head attention.  q: (..., Sq, D), k/v: (..., Sk, D).
    No GQA: the caller repeats K/V per query head.  With ``"cuda"`` the
    leading dims are flattened into one launch."""
    if backend == "torch":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if backend == "cuda":
        lead = q.shape[:-2]
        out = flash_attention(q.reshape((-1,) + q.shape[-2:]),
                              k.reshape((-1,) + k.shape[-2:]),
                              v.reshape((-1,) + v.shape[-2:]),
                              causal=causal, window=window, scale=scale,
                              block_q=block_q, block_k=block_k)
        return out.reshape(lead + out.shape[-2:])
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
        chunk: int = 64, backend: str = "torch") -> torch.Tensor:
    """SSD scan.  x: (..., S, H, P); dt: (..., S, H); B/C: (..., S, N); A
    and D (H,) are shared by the leading dims, which are a batch axis of
    one launch with ``"cuda"``."""
    if backend == "torch":
        return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    if backend == "cuda":
        return ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
