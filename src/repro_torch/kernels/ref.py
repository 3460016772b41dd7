"""Plain PyTorch oracles for the kernels of this package.

The port of ``repro/kernels/ref.py``; each oracle lands with the kernel it
checks, so this holds the GEMM's only.
"""

from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) in f32, whatever the operands' dtype."""
    return a.float() @ b.float()
